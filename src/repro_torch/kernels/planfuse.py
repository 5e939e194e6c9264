"""Launcher, limits and host tape split of the planfuse CUDA kernel
(``csrc/planfuse.cu``).

The kernel replaces the TPU megakernel ``planfuse_kernel``
(``src/repro/kernels/planfuse.py``): it evaluates the stack-machine tape
from ``core.query.lower_plan`` over m decoded leaf planes and writes the
root words plus each word's EWAH class in one pass.

Tape instructions (``(opcode, arg)`` int pairs):

  (0, i)  PUSH   leaf plane i onto the operand stack
  (1, 0)  NOT    complement the top of stack
  (2, k)  OP     pop b, pop a, push ``a <op_k> b``; k: 0=and, 1=or, 2=xor

The host splits a tape (:func:`split`) into what the kernel runs:

* ``pushes`` — the plane ids in PUSH order.  Each thread of the kernel
  copies its words of the next pushes ahead of time (cp.async into its own
  slots of a shared-memory ring), so the next plane is always in flight;
* ``code`` — one int per step, ``kind | op << 2 | slot << 4``, where the
  operand-stack slot of every step is resolved on the host (the stack
  pointer of a tape is static).  Kinds: ``LOAD`` (slot = next plane),
  ``LOADOP`` (slot = slot op next plane: a PUSH followed by an OP fuses
  into one step and needs no slot of its own), ``NOT`` and ``OP`` (slot =
  slot op slot + 1);
* ``depth`` — the slots the code touches, which picks the kernel's
  depth class D in {2, 4, 8, 16}: the stack lives in D x V registers a
  thread, every access under a switch on the (block-uniform) slot, so it
  never touches local memory.

The Hopper gate.  The reference gates the fused path on a VMEM budget;
here the limits are the kernel's own:

* ``MAX_TAPE_LEN`` — every block copies the code and the push list into
  static shared memory (8 KB at 1024 entries, beside a 32 KB ring).
* ``MAX_STACK_DEPTH`` — the deepest register stack compiled (D = 16: 64
  registers a thread at 4 words).  Deeper plans run per stage.
"""

from __future__ import annotations

import ctypes
from functools import cache
from typing import NamedTuple

import torch

PUSH, NOT, OP = 0, 1, 2
OP_AND, OP_OR, OP_XOR = 0, 1, 2

MAX_TAPE_LEN = 1024
MAX_STACK_DEPTH = 16

# kinds of a split step (csrc/planfuse.cu)
LOAD, LOADOP, CNOT, COP = 0, 1, 2, 3
DEPTH_CLASSES = (2, 4, 8, 16)


class Program(NamedTuple):
    """A tape split for the kernel: see the module docstring."""

    tape: tuple
    pushes: tuple
    code: tuple
    depth: int        # slots the code uses (<= the tape's stack peak)
    tape_depth: int   # the tape's operand-stack peak (the gate's measure)


def fits(tape, max_depth: int) -> bool:
    """The fused path's gate: can the kernel run this tape?"""
    return len(tape) <= MAX_TAPE_LEN and max_depth <= MAX_STACK_DEPTH


def split(tape) -> Program:
    """Check a tape and split it into the kernel's push list and step
    code.  Raises ``ValueError`` for a tape that pops an empty stack,
    leaves other than one operand, or exceeds the gate (:func:`fits`)."""
    tape = tuple((int(o), int(a)) for o, a in tape)
    pushes, code = [], []
    sp = peak = slots = 0
    i = 0
    while i < len(tape):
        opcode, arg = tape[i]
        if opcode == PUSH:
            if arg < 0:
                raise ValueError(f"tape pushes plane {arg}")
            pushes.append(arg)
            peak = max(peak, sp + 1)
            nxt = tape[i + 1] if i + 1 < len(tape) else None
            if sp >= 1 and nxt is not None and nxt[0] == OP and \
                    nxt[1] in (OP_AND, OP_OR, OP_XOR):
                code.append(LOADOP | nxt[1] << 2 | (sp - 1) << 4)
                i += 2
                continue
            code.append(LOAD | sp << 4)
            sp += 1
            slots = max(slots, sp)
        elif opcode == NOT:
            if sp < 1:
                raise ValueError("tape pops an empty operand stack")
            code.append(CNOT | (sp - 1) << 4)
        elif opcode == OP:
            if sp < 2 or arg not in (OP_AND, OP_OR, OP_XOR):
                raise ValueError("tape pops an empty operand stack"
                                 if sp < 2 else f"unknown tape op {arg}")
            code.append(COP | arg << 2 | (sp - 2) << 4)
            sp -= 1
        else:
            raise ValueError(f"unknown tape opcode {opcode}")
        i += 1
    if sp != 1:
        raise ValueError(f"tape leaves {sp} operands on the stack")
    if not fits(tape, peak):
        raise ValueError(
            f"tape of length {len(tape)} and depth {peak} exceeds the "
            f"kernel's limits ({MAX_TAPE_LEN}, {MAX_STACK_DEPTH})")
    return Program(tape, tuple(pushes), tuple(code), slots, peak)


def depth_class(depth: int) -> int:
    """The smallest compiled register-stack depth that holds ``depth``."""
    return next(d for d in DEPTH_CLASSES if d >= depth)


@cache
def _entry():
    from . import build

    p = ctypes.c_void_p
    return build.function("planfuse", "launch_planfuse",
                          [ctypes.c_int, p, ctypes.c_int, ctypes.c_longlong,
                           p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                           p, p, p])


def launch(x: torch.Tensor, prog: Program, code: torch.Tensor,
           pushes: torch.Tensor, r: torch.Tensor, kind: torch.Tensor) -> None:
    """x (m, n) int32 planes; ``code`` and ``pushes`` the program's int32
    tables on the same device; writes r (n,) and kind (n,)."""
    from . import build

    code_ = _entry()(x.device.index, x.data_ptr(), x.shape[0], x.shape[1],
                     code.data_ptr(), code.shape[0], pushes.data_ptr(),
                     pushes.shape[0], depth_class(prog.depth), r.data_ptr(),
                     kind.data_ptr(),
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check("planfuse", code_)
