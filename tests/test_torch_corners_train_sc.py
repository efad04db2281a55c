"""Port parity, training pointnet2-cls in the five comparison corners on the CPU
(baseline1/standard, baseline2/standard, pc2im/standard, baseline1/delayed,
baseline2/delayed) under SC W16A16, against the JAX package.

Each case (tests/_port.py `assert_corner_trains`): step 1's loss and every
gradient leaf against `jax.value_and_grad` of the reference's `loss_fn` on
the same bridged params and batch, three `TrainStep` steps against the
reference's (each step's loss), and a checkpoint of the trained state read
back byte-identical.  The bounds are tests/_port.py's, the main path's, except
that standard aggregation under SC holds the scale path to
STANDARD_SC_SCALE_PATH_REL (6e-2) instead of the main path's 2e-2
(SC_SCALE_PATH_REL), for the reason given there; delayed aggregation keeps
2e-2.  The JAX side compiles once a case, so the cases are split
by model and policy over four files; the others are
  tests/test_torch_corners_train.py,
  tests/test_torch_corners_train_seg.py,
  tests/test_torch_corners_train_seg_sc.py.
"""

import pytest

from _port import CORNER_IDS, CORNERS, assert_corner_trains
from _threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("preproc,aggregation", CORNERS, ids=CORNER_IDS)
def test_cls_corner_trains_as_the_reference_under_sc(preproc, aggregation, tmp_path):
    assert_corner_trains("cls", preproc, aggregation, "sc_w16a16", tmp_path)
