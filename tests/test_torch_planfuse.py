"""The planfuse kernel's host tape split and its plain version against the
reference.

* ``kernels.planfuse.split``: the push list is the tape's PUSH order, the
  tape depth is ``lower_plan``'s stack peak, a PUSH followed by its OP fuses
  into one LOADOP step, the slots the code uses pick the depth class, and
  bad tapes are rejected;
* ``ops.plan_fuse`` on CPU tensors (the plain version, which runs the
  split step by step on a slot-indexed stack, as the kernel does) against
  the reference's ``repro.kernels.ops.plan_fuse`` with its Pallas kernel
  in interpret mode, for tapes of every depth class up to depth 16, with
  NOT and xor, on plane widths that are not multiples of the kernel's
  tiles;
* depth-17 tapes: rejected by the split, sent per stage by
  ``TorchBackend``'s gate, and answering like ``JaxBackend`` in interpret
  mode.

Words are made with numpy from fixed seeds; every comparison is
bit-identical.  test_torch_cuda.py runs the kernel on the card.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import ewah as rewah
from repro.core.query import get_backend
from repro.kernels import ops as rops
from repro_torch.core import ewah as tewah
from repro_torch.core import query as TQ
from repro_torch.core.query import TorchBackend
from repro_torch.kernels import ops, planfuse


def mixed_words(shape, seed):
    """Random words with runs of 0 and 0xFFFFFFFF, so all classes appear."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, size=shape, dtype=np.uint32)
    kind = r.random(shape)
    words[kind < 0.3] = 0
    words[(kind >= 0.3) & (kind < 0.6)] = 0xFFFFFFFF
    return words


def t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def deep_root(depth, seed=0):
    """A right-nested tree whose operand stack peaks at ``depth``: each
    level combines a leaf (complemented at random) with the deeper rest,
    by a random and / or; a fold of two leaves with an xor at the bottom.
    Leaves are numbered in traversal order."""
    r = np.random.default_rng(seed)
    leaves = iter(range(10**6))

    def leaf():
        nd = ("leaf", next(leaves))
        return ("not", nd) if r.random() < 0.3 else nd

    def build(d):
        if d <= 2:
            return ("fold", ("xor",), (leaf(), leaf())) if d == 2 else leaf()
        op = "and" if r.random() < 0.5 else "or"
        first = leaf()
        return (op, (first, build(d - 1)))

    return build(depth)


def n_leaves(root):
    if root[0] == "leaf":
        return 1
    if root[0] == "not":
        return n_leaves(root[1])
    kids = root[2] if root[0] == "fold" else root[1]
    return sum(n_leaves(c) for c in kids)


def test_split_push_order_depth_and_fusion():
    tape = ((0, 2), (0, 0), (2, 1), (0, 1), (1, 0), (0, 3), (2, 2), (2, 0))
    prog = planfuse.split(tape)
    assert prog.tape == tape
    assert prog.pushes == (2, 0, 1, 3)
    assert prog.tape_depth == 3
    kinds = [(c & 3, (c >> 2) & 3, c >> 4) for c in prog.code]
    assert kinds == [(planfuse.LOAD, 0, 0), (planfuse.LOADOP, 1, 0),
                     (planfuse.LOAD, 0, 1), (planfuse.CNOT, 0, 1),
                     (planfuse.LOADOP, 2, 1), (planfuse.COP, 0, 0)]
    assert prog.depth == 2 and planfuse.depth_class(prog.depth) == 2


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 8, 9, 16])
def test_split_depth_matches_lower_plan(depth):
    root = deep_root(depth, seed=depth)
    tape, peak = TQ.lower_plan(root)
    prog = planfuse.split(tape)
    assert prog.tape_depth == peak == depth
    assert prog.pushes == tuple(a for o, a in tape if o == planfuse.PUSH)
    assert prog.pushes == tuple(range(n_leaves(root)))
    assert 1 <= prog.depth <= depth
    assert planfuse.depth_class(prog.depth) >= prog.depth
    assert all((c >> 4) < prog.depth for c in prog.code)


@pytest.mark.parametrize("tape,match", [
    (((1, 0),), "empty operand stack"),
    (((0, 0), (2, 0)), "empty operand stack"),
    (((0, 0), (0, 1)), "leaves 2 operands"),
    (((0, 0), (0, 1), (2, 7)), "unknown tape op"),
    (((0, 0), (5, 0)), "unknown tape opcode"),
    (((0, -1),), "pushes plane"),
    (tuple((0, 0) for _ in range(17)) + tuple((2, 1) for _ in range(16)),
     "exceeds the kernel's limits"),
    (((0, 0),) + tuple(x for _ in range(512) for x in ((0, 0), (2, 1))),
     "exceeds the kernel's limits"),
])
def test_split_rejects_bad_tapes(tape, match):
    with pytest.raises(ValueError, match=match):
        planfuse.split(tape)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("n", [3001, 4096])
def test_plan_fuse_plain_matches_reference_per_depth_class(depth, n):
    tape, _ = TQ.lower_plan(deep_root(depth, seed=depth + n))
    m = len([1 for o, _ in tape if o == planfuse.PUSH])
    x = mixed_words((m, n), seed=depth * 7 + n)
    want_r, want_k = rops.plan_fuse(x, tape)          # Pallas, interpreted
    got_r, got_k = ops.plan_fuse(t(x), tape)
    np.testing.assert_array_equal(got_r.numpy().view(np.uint32),
                                  np.asarray(want_r))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    prog = planfuse.split(tape)                       # a memoised split
    again_r, _ = ops.plan_fuse(t(x), prog)
    assert torch.equal(again_r, got_r)


def ewah_plan(P, ew, root, n_rows, seed):
    """A plan of package P over random leaf streams for ``root``."""
    words = mixed_words((n_leaves(root), -(-n_rows // 32)), seed)
    return P.query.Plan(streams=[ew.compress(w) for w in words], root=root,
                        n_rows=n_rows)


@pytest.mark.parametrize("depth", [16, 17])
def test_gate_and_backends_agree_at_the_depth_limit(depth):
    """Depth 16 runs fused, depth 17 per stage; both answer like JaxBackend
    in interpret mode."""
    root = deep_root(depth, seed=3)
    be = TorchBackend(device="cpu")
    share = tuple(range(n_leaves(root)))
    assert (be._fused_program(root, share) is None) == (depth > 16)
    if depth > 16:
        with pytest.raises(ValueError, match="exceeds the kernel's limits"):
            planfuse.split(TQ.lower_plan(root)[0])
    n_rows = 3001 * 32 - 5
    got = be.execute_compressed_many([ewah_plan(T, tewah, root, n_rows, 9)])
    want = get_backend("jax", interpret=True).execute_compressed_many(
        [ewah_plan(R, rewah, root, n_rows, 9)])
    np.testing.assert_array_equal(got[0].data, want[0].data)
