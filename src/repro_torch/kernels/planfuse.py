"""Launcher and limits of the planfuse CUDA kernel (``csrc/planfuse.cu``).

The kernel replaces the TPU megakernel ``planfuse_kernel``
(``src/repro/kernels/planfuse.py``): it interprets the stack-machine tape
from ``core.query.lower_plan`` over m decoded leaf planes and writes the
root words plus each word's EWAH class in one pass.

Tape instructions (``(opcode, arg)`` int pairs):

  (0, i)  PUSH   leaf plane i onto the operand stack
  (1, 0)  NOT    complement the top of stack
  (2, k)  OP     pop b, pop a, push ``a <op_k> b``; k: 0=and, 1=or, 2=xor

The Hopper gate.  The reference gates the fused path on a VMEM budget; here
the limits are the kernel's own, compiled into it from the two constants
below:

* ``MAX_TAPE_LEN`` — every block copies the tape into static shared
  memory as int2 pairs: 1024 entries are 8 KB, far inside the 48 KB a
  block may declare statically, so shared memory never limits how many
  blocks an SM holds (registers and threads do).  The longest tape the
  query mixes compile (a Gray-coded bit-sliced range over a 12-bit
  column) is a few hundred entries.
* ``MAX_STACK_DEPTH`` — each thread keeps its operand stack in a local
  array of ``MAX_STACK_DEPTH`` x 16 bytes (4 words).  A plan of depth d
  touches d x 16 B per thread; at the SM's 2048 resident threads, d = 16
  is 512 KB, already past what the SM's L1 can cache, so deeper plans
  would run their stack traffic through L2.  The per-stage path, which
  round-trips every intermediate through device memory anyway, takes them.

A plan whose tape is longer or whose stack is deeper runs per stage.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

PUSH, NOT, OP = 0, 1, 2
OP_AND, OP_OR, OP_XOR = 0, 1, 2

MAX_TAPE_LEN = 1024
MAX_STACK_DEPTH = 16


def fits(tape, max_depth: int) -> bool:
    """The fused path's gate: can the kernel run this tape?"""
    return len(tape) <= MAX_TAPE_LEN and max_depth <= MAX_STACK_DEPTH


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("planfuse", "launch_planfuse",
                          [ctypes.c_int, p, ctypes.c_longlong, p,
                           ctypes.c_int, p, p, p])


def launch(x: torch.Tensor, tape: torch.Tensor, r: torch.Tensor,
           kind: torch.Tensor) -> None:
    """x (m, n) int32 planes, tape (L, 2) int32 on the same device;
    writes r (n,) and kind (n,)."""
    from . import build

    fn = _entry()
    code = fn(x.device.index, x.data_ptr(), x.shape[1], tape.data_ptr(),
              tape.shape[0], r.data_ptr(), kind.data_ptr(),
              torch.cuda.current_stream(x.device).cuda_stream)
    build.check("planfuse", code)
