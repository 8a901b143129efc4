"""The masked mxm under the semirings whose ⊕ is not associative, or
rounds (GreaterPlus, CustomLessPlus, CustomLessLess, NotEqualToPlus,
MultipliesMultiplies), and the masked mxm where no mask edge walks a lane,
on the CPU against the JAX spgemm_masked.

The same COO, made with NumPy from a seed, goes to both packages; the JAX
side runs its chunked sort joins on the CPU. The port's plain version
builds the JAX join's lanes (the shorter list of each edge, B's only when
strictly shorter, ascending; the identity where the other list lacks an
id) and folds them through segops.segmented_scan, the JAX join's
bracketing, so every value is held bitwise: no tolerance.
tests/test_torch_intersect_replay.py replays the kernel's order against the
plain version; tests/test_torch_cuda.py holds the kernel to both on the
card.
"""
import numpy as np
import pytest
import torch

import graphblast_tpu as jgb
import graphblast_tpu_torch as tgb
from graphblast_tpu.ops.spgemm import spgemm_masked as jspgemm_masked
from graphblast_tpu_torch.ops import spgemm as sp
from graphblast_tpu_torch.ops.kernels import masked_intersect as mx
from test_torch_intersect_replay import _long_lists_coo, fuzz_coo, nested_coo

ORDERED = ["GreaterPlus", "CustomLessPlus", "CustomLessLess",
           "NotEqualToPlus", "MultipliesMultiplies"]


def _both(coo, n, dtype):
    """The COO triples as (JAX, port) Matrix pairs on the CPU."""
    out = []
    for r, c, v in coo:
        v = np.asarray(v, dtype)
        out.append((jgb.Matrix.from_coo(r, c, v, n, n, dtype=v.dtype),
                    tgb.Matrix.from_coo(r, c, v, n, n,
                                        dtype=torch.from_numpy(v[:0]).dtype,
                                        device="cpu")))
    return out


def _values(C, M):
    """C's values at M's stored entries, in M's COO order."""
    mr, mc, _ = M.extract_tuples()
    r, c, v = C.extract_tuples()
    d = np.zeros(C.shape, v.dtype)
    d[r, c] = v
    return d[mr, mc]


def _graph(make, dtype, transpose_b):
    if make == "fuzz0":
        return fuzz_coo(0, dtype)
    if make == "fuzz1":
        return fuzz_coo(1, dtype)
    if make == "nested":
        return nested_coo(0, dtype, transpose_b)
    return _long_lists_coo(1, dtype, transpose_b)


@pytest.mark.parametrize("transpose_b", [False, True])
@pytest.mark.parametrize("make", ["fuzz0", "fuzz1", "nested", "long"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", ORDERED)
def test_ordered_masked_mxm_equals_jax(name, dtype, make, transpose_b):
    """Bitwise equal to the JAX spgemm_masked, on inputs with edges where
    B's side is expanded, edges whose lists share no id (the fuzz and
    nested lists) and walks of several 32-lane rounds (the long lists); the
    nested and long lists, and the int32 fuzz values, hold negative
    values."""
    n, coo = _graph(make, dtype, transpose_b)
    (JA, A), (JB, B), (JM, M) = _both(coo, n, dtype)
    got = sp.spgemm_masked(A, B, M, getattr(tgb.semiring, f"{name}Semiring"),
                           transpose_b=transpose_b)
    want = jspgemm_masked(JA, JB, JM,
                          getattr(jgb.semiring, f"{name}Semiring"),
                          transpose_b=transpose_b)
    g = _values(got, M)
    w = np.asarray(want.to_dense())[tuple(M.extract_tuples()[:2])]
    assert g.dtype == np.dtype(dtype)
    assert g.tobytes() == w.astype(dtype).tobytes()
    # the inputs reach what the fold order decides
    mi, mj, a_ptr, a_ind, _, b_ptr, b_ind, _ = sp._operands(A, B, M,
                                                           transpose_b)
    len_a = (a_ptr[mi.long() + 1] - a_ptr[mi.long()]).long()
    len_b = (b_ptr[mj.long() + 1] - b_ptr[mj.long()]).long()
    assert bool((len_b < len_a).any())          # B's side expanded
    hits = torch.bincount(
        torch.cat([e for e, _, _ in mx._plain_matches(
            mi, mj, a_ptr, a_ind, b_ptr, b_ind)]), minlength=mi.shape[0])
    if make != "long":   # long lists (several 32-lane rounds) all meet
        assert bool(((hits == 0) & (torch.minimum(len_a, len_b) > 0))
                    .any())
    else:
        assert int(torch.minimum(len_a, len_b).max()) > 64
    if make in ("nested", "long") or dtype == np.int32:   # negatives
        assert (np.asarray(coo[0][2]) < 0).any()


@pytest.mark.parametrize("transpose_b", [False, True])
def test_plus_divides_int32_raises_as_jax(transpose_b):
    """PlusDivides on int32: JAX's true division leaves int32 and its
    spgemm_masked raises TypeError; so does the port, on either route."""
    n, coo = fuzz_coo(2, np.int32)
    (JA, A), (JB, B), (JM, M) = _both(coo, n, np.int32)
    with pytest.raises(TypeError):
        jspgemm_masked(JA, JB, JM, jgb.semiring.PlusDividesSemiring,
                       transpose_b=transpose_b)
    with pytest.raises(TypeError, match="int32"):
        sp.spgemm_masked(A, B, M, tgb.semiring.PlusDividesSemiring,
                         transpose_b=transpose_b)
    with pytest.raises(TypeError, match="int32"):
        sp.spgemm_masked_plain(A, B, M, tgb.semiring.PlusDividesSemiring,
                               transpose_b=transpose_b)


def _empty_walk_coo(dtype, walked_any: bool):
    """A, B and M on 6 vertices, B taken transposed, where every mask edge
    has an empty list on one side (so no edge walks a lane) or, with
    `walked_any`, one more edge walks lists that share no id."""
    # A's rows: 0 {1, 2}, 1 {2}, 3 {4}; B's rows: 1 {0}, 2 {3}, 4 {1}, 5 {1}
    ar, ac = np.array([0, 0, 1, 3]), np.array([1, 2, 2, 4])
    br, bc = np.array([1, 2, 4, 5]), np.array([0, 3, 1, 1])
    # (0, 0) and (1, 3): B's row empty; (2, 1) and (4, 2): A's row empty
    mr, mc = np.array([0, 1, 2, 4]), np.array([0, 3, 1, 2])
    if walked_any:   # A's row 3 {4} against B's row 1 {0}: one lane, no hit
        mr, mc = np.append(mr, 3), np.append(mc, 1)
    vals = (lambda m: -np.arange(1, m + 1).astype(dtype))
    return 6, [(ar, ac, vals(len(ar))), (br, bc, vals(len(br))),
               (mr, mc, np.ones(len(mr), dtype))]


@pytest.mark.parametrize("walked_any", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", ["MinimumPlus", "MaximumMultiplies",
                                  "PlusMultiplies", "GreaterPlus",
                                  "MultipliesMultiplies"])
def test_masked_mxm_without_a_walked_lane_equals_jax(name, dtype,
                                                     walked_any):
    """Where no mask edge walks a lane the JAX plan is None and its result
    zeros; the port's kernel route (the wrapper, plain on the CPU) and
    plain route give zeros too. With one edge that walks, the JAX plan
    exists and every edge holds ⊕'s identity in both (the walked edge's
    one lane misses)."""
    n, coo = _empty_walk_coo(dtype, walked_any)
    (JA, A), (JB, B), (JM, M) = _both(coo, n, dtype)
    want = np.asarray(jspgemm_masked(
        JA, JB, JM, getattr(jgb.semiring, f"{name}Semiring"),
        transpose_b=True).to_dense())[tuple(M.extract_tuples()[:2])]
    sr = getattr(tgb.semiring, f"{name}Semiring")
    for fn in (sp.spgemm_masked, sp.spgemm_masked_plain):
        got = _values(fn(A, B, M, sr, transpose_b=True), M)
        assert got.tobytes() == want.astype(dtype).tobytes()
    # both routes read one flag, computed once and kept with the mask
    (flag,) = [f for _, _, f in M._plans["intersect/empty"]]
    assert bool(flag) == (not walked_any)
    ident = sr.identity(torch.from_numpy(np.zeros(0, dtype)).dtype).item()
    assert (want == (ident if walked_any else 0)).all()


@pytest.mark.parametrize("name", ORDERED)
def test_trace_of_an_ordered_fold_raises(name):
    """The JAX trace folds these ⊕ in XLA's reduce order over every stored
    entry; the port refuses the trace rather than answer in another
    order."""
    n, coo = fuzz_coo(0)
    (_, A), (_, B), _ = _both(coo, n, np.float32)
    with pytest.raises(NotImplementedError, match="reduce order"):
        tgb.trace_mxm_transpose(A, B, getattr(tgb.semiring,
                                              f"{name}Semiring"))
