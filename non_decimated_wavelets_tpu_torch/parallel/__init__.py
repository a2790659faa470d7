"""Multi-rank transforms on ``torch.distributed`` (``sharded.py``)."""

from .sharded import ShardedNDDWT, make_mesh

__all__ = ["ShardedNDDWT", "make_mesh"]
