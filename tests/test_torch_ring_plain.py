"""Ring attention's plain form and Ulysses against the JAX package's, on the
CPU (the kernel forms: `test_torch_ring_forms.py`, whose helpers and
`sep2` fixture this file shares).

- S = 128 over sep = 2 (shards of 64 rows, not a multiple of 128): the
  plain ring, causal and not, torch ops under autograd on the port's side;
- Ulysses (`ulysses_attention_array`): heads split over the axis, `sdpa`
  per rank;
- without a sep axis (or at degree 1) both entries are `sdpa`.

Tolerances as in `test_torch_ring_forms.py`: outputs within 1e-4,
gradients within 1e-3 (float32).
"""

import pytest
import torch

from paddle_tpu.distributed.fleet.meta_parallel import ring_attention as ra
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as tra
from paddle_tpu_torch.ops import flash_attention as pfa
from test_torch_ring_forms import (  # noqa: F401  (sep2 is a fixture)
    _check,
    _inputs,
    _port,
    _reference,
    _rng_neutral,
    sep2,
)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_ring_matches_reference(sep2, causal):
    q, k, v = _inputs(128, seed=128 + int(causal))
    ref = _reference(lambda *x: ra.ring_attention_array(*x, "sep", causal), q, k, v)
    got = _port(lambda *x: tra.ring_attention_array(*x, "sep", causal), q, k, v)
    _check(ref, got)
    assert tra.form_counts == dict(dict.fromkeys(tra.FORMS, 0), plain=1)
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)


def test_ulysses_matches_reference(sep2):
    q, k, v = _inputs(128, seed=3, h=4)
    ref = _reference(lambda *x: ra.ulysses_attention_array(*x, "sep", True), q, k, v)
    got = _port(lambda *x: tra.ulysses_attention_array(*x, "sep", True), q, k, v)
    _check(ref, got)
    assert tra.form_counts["ulysses"] == 1


def test_without_a_sep_axis_ring_attention_is_sdpa():
    saved = tmesh.get_mesh()
    try:
        tmesh.set_mesh(None)
        q, k, v = (torch.from_numpy(x) for x in _inputs(64, seed=4))
        torch.testing.assert_close(tra.ring_attention_array(q, k, v),
                                   pfa.sdpa(q, k, v, None, True))
        tmesh.build_mesh(sep=1, device="cpu")
        torch.testing.assert_close(tra.ulysses_attention_array(q, k, v),
                                   pfa.sdpa(q, k, v, None, True))
    finally:
        tmesh.set_mesh(saved)


def test_zigzag_layout_and_starts_match_the_reference_and_are_built_once():
    """`_zigzag_perm` is the reference's permutation; a rank's q block
    starts are the reference's and are built once per (S, R, rank,
    device), so a layer's call makes no host-to-device copy."""
    import numpy as np

    import paddle_tpu.ops.flash_attention as fa

    fwd, inv = tra._zigzag_perm(2048, 4, "cpu")
    rfwd, rinv = ra._zigzag_perm(2048, 4)
    np.testing.assert_array_equal(fwd.numpy(), rfwd)
    np.testing.assert_array_equal(inv.numpy(), rinv)
    assert tra._zigzag_perm(2048, 4, "cpu")[0] is fwd
    starts = tra._zigzag_starts(2048, 4, 1, "cpu")
    assert tra._zigzag_starts(2048, 4, 1, "cpu") is starts
    ref = fa.q_block_starts([(256, 256), (6 * 256, 256)], 256)
    assert starts.tolist() == np.asarray(ref).tolist()
