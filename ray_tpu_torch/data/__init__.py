"""ray_tpu_torch.data — streaming datasets for GPU ingest (a copy of
``ray_tpu.data``).

Analogue of Ray Data (reference: python/ray/data/__init__.py public
surface), rebuilt linear: blocks stream through generator tasks; batches
land as torch tensors through ``iter_torch_batches`` (zero-copy out of
the shm store, then pinned buffers and an asynchronous copy to the card).
No module here imports ``torch`` at import time: the data tasks, map
actors and the split coordinator run without it. The batch-inference
bridge (``ray_tpu.data.llm``) waits for the serve control plane.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.dataset import (DataIterator, Dataset, from_blocks,
                                        from_items, from_numpy,
                                        range,  # noqa: A004
                                        read_binary_files, read_csv,
                                        read_images, read_json, read_lance,
                                        read_parquet, read_text,
                                        read_webdataset)
from ray_tpu_torch.data import preprocessors

__all__ = [
    "Block", "BlockAccessor", "concat_blocks",
    "Dataset", "DataIterator",
    "range", "from_items", "from_numpy", "from_blocks",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files", "read_images", "read_webdataset",
    "read_lance", "preprocessors",
]
