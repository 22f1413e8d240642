"""Trial state + the TrialRunner actor (counterpart of
``ray_tpu/tune/trial.py``).

Analogue of the reference's trial execution (reference: python/ray/tune/
experiment/trial.py Trial states, tune/trainable/function_trainable.py —
the user function runs in a thread and reports through a session). One
TrialRunner actor per trial; the controller polls it like the Train
controller polls its workers.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

PENDING, RUNNING, TERMINATED, ERROR, STOPPED = (
    "PENDING", "RUNNING", "TERMINATED", "ERROR", "STOPPED")


class _TuneSession:
    def __init__(self, restored: Optional[bytes] = None,
                 start_iteration: int = 0):
        self.lock = threading.Lock()
        self.reported: List[Dict[str, Any]] = []
        self.iteration = start_iteration
        self.stop_requested = False
        self.finished = False
        self.error: Optional[str] = None
        self.checkpoint: Optional[bytes] = None  # latest saved state
        self.ckpt_version = 0                    # bumps on every save
        self.ckpt_iteration = 0                  # iteration it captured
        self.restored = restored                 # state to resume from


_session: Optional[_TuneSession] = None


def report(metrics: Dict[str, Any], *,
           checkpoint: Any = None) -> None:
    """Report one iteration's metrics from inside a trainable (reference:
    ray.tune.report, with checkpoint= as in train.report). Raises
    StopIteration-like exit when the scheduler stopped this trial.
    Checkpoints make the trial PBT-exploitable."""
    if _session is None:
        raise RuntimeError("tune.report() called outside a trial")
    with _session.lock:
        _session.iteration += 1
        _session.reported.append(dict(metrics))
        if checkpoint is not None:
            _session.checkpoint = cloudpickle.dumps(checkpoint)
            _session.ckpt_iteration = _session.iteration
            _session.ckpt_version += 1
        if _session.stop_requested:
            raise _TrialStopped()


def get_checkpoint() -> Any:
    """State this trial should resume from (None on a fresh start;
    a PBT exploit restarts the trial with the source's checkpoint —
    reference: ray.tune.get_checkpoint)."""
    if _session is None:
        raise RuntimeError("tune.get_checkpoint() outside a trial")
    if _session.restored is None:
        return None
    return cloudpickle.loads(_session.restored)


class _TrialStopped(BaseException):
    """Control-flow exception: scheduler stopped the trial (not an error)."""


class TrialRunner:
    """Actor hosting one trial's trainable function."""

    def __init__(self, fn_blob: bytes, config: dict,
                 restored: Optional[bytes] = None,
                 start_iteration: int = 0):
        global _session
        self._session = _TuneSession(restored, start_iteration)
        _session = self._session
        fn = cloudpickle.loads(fn_blob)

        def run():
            try:
                fn(config)
            except _TrialStopped:
                pass
            except BaseException:
                self._session.error = traceback.format_exc()
            finally:
                self._session.finished = True

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="trial")
        self._thread.start()
        self._ckpt_sent = 0

    def poll(self) -> dict:
        s = self._session
        with s.lock:
            reported = s.reported
            s.reported = []
            out = {
                "reported": reported,
                "iteration": s.iteration,
                "finished": s.finished,
                "error": s.error,
            }
            # Ship NEW checkpoints to the controller so a trial can be
            # rescheduled from its latest state after a node loss
            # (reference: trial checkpoints persist to storage; here the
            # controller is the storage).
            if s.ckpt_version > self._ckpt_sent:
                out["checkpoint"] = s.checkpoint
                out["checkpoint_iteration"] = s.ckpt_iteration
                self._ckpt_sent = s.ckpt_version
            return out

    def stop_trial(self) -> None:
        with self._session.lock:
            self._session.stop_requested = True

    def get_trial_checkpoint(self) -> Optional[bytes]:
        """Latest checkpoint blob (PBT exploit source)."""
        with self._session.lock:
            return self._session.checkpoint
