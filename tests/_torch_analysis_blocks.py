"""A MoE block with one all-reduce more than the census prices, for the
trace contract's negative case (tests/test_torch_analysis.py).  A module of
its own, importing no JAX, so the spawned ranks can load it."""

from repro_torch.core import collectives as C
from repro_torch.models.moe import moe_block


def moe_block_extra_psum(p, x, cfg, plan):
    out = moe_block(p, x, cfg, plan)
    C.psum(x, plan.mesh, plan.tp_axes)
    return out
