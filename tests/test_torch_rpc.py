"""The port's RPC layer (``ray_tpu_torch/core/rpc.py``): a stopped
``RpcServer`` drops its established connections before it waits for its
listeners to close, so ``stop`` returns while a client is still
connected with a call in flight, and that call fails instead of hanging.
(Since CPython 3.12.1 ``asyncio.Server.wait_closed`` returns only once
every connection has closed; the JAX package's ``RpcServer.stop`` waits
first and so hangs while a client stays connected.)
"""

import asyncio
import time

import pytest

from ray_tpu_torch.core.rpc import RpcClient, RpcConnectionLost, RpcServer


@pytest.mark.timeout(30)
def test_stop_with_a_connected_client_and_a_call_in_flight():
    async def main():
        release = asyncio.Event()
        entered = asyncio.Event()

        class Svc:
            async def hang(self):
                entered.set()
                await release.wait()

        srv = RpcServer("t")
        srv.register_object(Svc())
        port = await srv.start_tcp("127.0.0.1", 0)
        client = RpcClient(("127.0.0.1", port))
        call = asyncio.ensure_future(client.call("hang"))
        await asyncio.wait_for(entered.wait(), 10.0)
        assert srv._conns  # the client is connected, its call in flight
        t = time.monotonic()
        try:
            await asyncio.wait_for(srv.stop(), 2.0)
            # Not a TimeoutError: the call fails, it does not hang.
            with pytest.raises((RpcConnectionLost, ConnectionError)):
                await asyncio.wait_for(call, 2.0)
            assert time.monotonic() - t < 2.0
            assert not srv._conns and not srv._servers
        finally:
            release.set()
            await client.close()

    asyncio.run(main())
