"""Each op of the sharded rollout's ref namespaces alone against the JAX
package's (``shardmap_step.sharded_ops``, ``shardmap2d.sharded_ops_2d``),
under shard_map on 8 virtual CPU devices and ``parallel.mesh.run`` on 8
CPU shards, on one numpy-made 128² stack: the ops ``make_step`` reaches
through ``advect_both`` and the multigrid hook alone (the advections, the
confinements, the sweep-by-sweep diffusion and pressure, divergence and
projection, splats, the strip and the render at global coordinates).
Float32 rounding (1e-6 of scale: the same formulas), the frame equal.
"""

import numpy as np
import pytest
import torch

import shard_pairs as sp
from cudafluidsimulation_tpu_torch.parallel import shardmap2d as tss2
from cudafluidsimulation_tpu_torch.parallel import shardmap_step as tss

torch.set_num_threads(1)


@pytest.mark.parametrize("op", list(sp.NAMESPACE_OPS))
def test_rows_namespace_op_matches_jax(op):
    # each op of the ref namespace alone, on 8 shards of a 128² stack
    from cudafluidsimulation_tpu.parallel import shardmap_step as jss

    got, exp = sp.namespace_case("rows", op, jss.sharded_ops("x", 128, 15),
                                 tss.sharded_ops("x", 128, 15), 128, 128)
    if exp.dtype == np.uint8:  # the frame: equal
        np.testing.assert_array_equal(got, exp)
    else:  # the same formulas: float32 rounding
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * max(np.abs(exp).max(), 1.0))


@pytest.mark.parametrize("op", list(sp.NAMESPACE_OPS))
def test_2d_namespace_op_matches_jax(op):
    # each op of the 2-D ref namespace alone, on 2 x 4 shards of 128²
    from cudafluidsimulation_tpu.parallel import shardmap2d as jss2

    got, exp = sp.namespace_case("2d", op, jss2.sharded_ops_2d("rows", "cols", 128, 128, 15),
                                 tss2.sharded_ops_2d("rows", "cols", 128, 128, 15), 128, 128)
    if exp.dtype == np.uint8:  # the frame: equal
        np.testing.assert_array_equal(got, exp)
    else:  # the same formulas: float32 rounding
        np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * max(np.abs(exp).max(), 1.0))
