from ..core.device.request_scheduler import AdmissionRejected
from .engine import ServingEngine
from .paged_kv import (SINK_BLOCK, BlockAllocator, PoolExhausted,
                       prefix_block_keys)
from .speculative import Speculator

__all__ = ["AdmissionRejected", "ServingEngine", "SINK_BLOCK",
           "BlockAllocator", "PoolExhausted", "prefix_block_keys",
           "Speculator"]
