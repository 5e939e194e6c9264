"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the
reference's wrappers (``repro.kernels.ops``), which run their Pallas
kernels in interpret mode on the CPU, as the reference's own tests do.
Here the port's wrappers take their plain PyTorch versions (CPU tensors);
test_torch_cuda.py holds each CUDA kernel against its plain version on
the card.  Inputs are random words mixed with
runs of 0 and all-ones, made with numpy from fixed seeds.  Every comparison
is bit-identical.
"""

import numpy as np
import pytest
import torch

from repro.core import query as RQ
from repro.kernels import ops as rops
from repro.kernels import planfuse as rplanfuse
from repro_torch.core import query as TQ
from repro_torch.kernels import ops, planfuse, ref


def mixed_words(shape, seed):
    """Random words with runs of 0 and 0xFFFFFFFF, so all classes appear."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, size=shape, dtype=np.uint32)
    kind = r.random(shape)
    words[kind < 0.3] = 0
    words[(kind >= 0.3) & (kind < 0.6)] = 0xFFFFFFFF
    flat = words.reshape(-1)
    # long clean runs too, not only isolated clean words
    flat[: flat.size // 5] = 0
    flat[flat.size // 3: flat.size // 2] = 0xFFFFFFFF
    return words


def t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def u32(x):
    return np.asarray(x.numpy()).view(np.uint32)


TAPE = ((0, 0), (0, 1), (2, 1), (0, 2), (1, 0), (2, 0), (0, 3), (2, 2))


def test_tape_opcodes_agree_with_reference():
    assert (planfuse.PUSH, planfuse.NOT, planfuse.OP) == (
        rplanfuse.PUSH, rplanfuse.NOT, rplanfuse.OP)
    assert (planfuse.OP_AND, planfuse.OP_OR, planfuse.OP_XOR) == (
        rplanfuse.OP_AND, rplanfuse.OP_OR, rplanfuse.OP_XOR)
    assert (TQ.TAPE_PUSH, TQ.TAPE_NOT, TQ.TAPE_OP) == (
        RQ.TAPE_PUSH, RQ.TAPE_NOT, RQ.TAPE_OP)
    assert TQ._TAPE_OP_IDS == RQ._TAPE_OP_IDS


@pytest.mark.parametrize("n", [3000, 8192])
def test_plan_fuse_matches_reference(n):
    x = mixed_words((4, n), seed=n)
    want_r, want_k = rops.plan_fuse(x, TAPE)
    got_r, got_k = ops.plan_fuse(t(x), TAPE)
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


def test_recompress_batch_matches_reference():
    w = mixed_words((3, 500), seed=7)
    want_s, want_l = rops.recompress_batch(w, 501)
    got_s, got_l, _ = ops.recompress_batch(t(w), 501)
    want_l = np.asarray(want_l)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    for b in range(3):
        np.testing.assert_array_equal(u32(got_s)[b, : want_l[b]],
                                      np.asarray(want_s)[b, : want_l[b]])


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_wordops_matches_reference(op):
    x = mixed_words((2, 3000), seed=3)
    want_r, want_c = rops.wordops(x[0], x[1], op)
    got_r, got_c = ops.wordops(t(x[0]), t(x[1]), op)
    np.testing.assert_array_equal(u32(got_r), np.asarray(want_r))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("m", [1, 2, 5])
def test_wordops_fold_matches_reference(m):
    x = mixed_words((m, 1000), seed=m)
    want = rops.wordops_fold(x, "or")
    np.testing.assert_array_equal(u32(ops.wordops_fold(t(x), "or")),
                                  np.asarray(want))


def test_slice_fold_matches_reference():
    ops_seq = ("and", "or", "xor", "and")
    x = mixed_words((5, 3000), seed=5)
    want = rops.slice_fold(x, ops_seq)
    np.testing.assert_array_equal(u32(ops.slice_fold(t(x), ops_seq)),
                                  np.asarray(want))


def test_wrapper_checks():
    x = t(mixed_words((2, 64), seed=1))
    with pytest.raises(ValueError, match="m - 1"):
        ops.slice_fold(x, ("and", "or"))
    with pytest.raises(ValueError, match="unknown word op"):
        ops.wordops(x[0], x[1], "nand")
    with pytest.raises(ValueError, match="pushes plane"):
        ops.plan_fuse(x, ((0, 2),))
    with pytest.raises(ValueError, match="leaves 2 operands"):
        ops.plan_fuse(x, ((0, 0), (0, 1)))
    deep = tuple((0, 0) for _ in range(planfuse.MAX_STACK_DEPTH + 1)) + \
        tuple((2, 0) for _ in range(planfuse.MAX_STACK_DEPTH))
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        ops.plan_fuse(x, deep)


def test_cpu_calls_launch_no_kernel():
    """On CPU tensors every wrapper takes its plain version: no counter
    moves."""
    ops.reset_launches()
    x = t(mixed_words((4, 256), seed=2))
    ops.plan_fuse(x, TAPE)
    ops.wordops_fold(x, "and")
    ops.slice_fold(x, ("and", "or", "xor"))
    ops.recompress_batch(x[:2].contiguous(), 257)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_plain_versions_match_numpy_stack_machine():
    x = mixed_words((4, 777), seed=9)
    stack = []
    for opcode, arg in TAPE:
        if opcode == 0:
            stack.append(x[arg])
        elif opcode == 1:
            stack.append(stack.pop() ^ np.uint32(0xFFFFFFFF))
        else:
            b, a = stack.pop(), stack.pop()
            stack.append([np.bitwise_and, np.bitwise_or,
                          np.bitwise_xor][arg](a, b))
    want = stack.pop()
    r, kind = ref.plan_fuse(t(x), TAPE)
    np.testing.assert_array_equal(u32(r), want)
    np.testing.assert_array_equal(
        kind.numpy(), np.where(want == 0, 0, np.where(want == 0xFFFFFFFF, 1, 2)))
