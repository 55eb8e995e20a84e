"""Differentiable kernel calls.

Counterpart of the JAX package's ``custom_vjp`` wrappers around its Pallas
kernels (``ops/norm.py:_gn_silu_bwd``, ``ops/attention.py:_linattn_block_bwd``
and the others): no TPU kernel has a backward kernel, so each backward
recomputes the plain composition on the saved inputs and differentiates it.
Here that is one ``torch.autograd.Function``. Its forward runs the hand
kernel for a CUDA tensor and the plain version for a CPU tensor; its
backward never launches a kernel, so launch counts stay those of the
forward. Gradients reach every tensor input, the float32 weights included
(the kernels' bf16 casts and prenorm folds happen inside their wrappers).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["kernel_call"]


class _KernelCall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: Callable, plain: Callable, *args):
        ctx.plain = plain
        ctx.is_tensor = tuple(torch.is_tensor(a) for a in args)
        ctx.consts = tuple(None if t else a for a, t in zip(args, ctx.is_tensor))
        ctx.save_for_backward(*(a for a in args if torch.is_tensor(a)))
        return run(*args)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        inputs, wrt = [], []
        for is_tensor, const, need in zip(ctx.is_tensor, ctx.consts, needs):
            if not is_tensor:
                inputs.append(const)
                continue
            t = next(saved).detach().requires_grad_(need)
            inputs.append(t)
            if need:
                wrt.append(t)
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None) + tuple(next(grads) if need else None for need in needs)


def kernel_call(kernel: Callable, plain: Callable, *args):
    """``kernel(*args)`` for a tensor ``args[0]`` off the CPU (the wrapper
    launches or raises), ``plain(*args)`` on the CPU; differentiable through
    ``plain`` either way."""
    run = plain if args[0].device.type == "cpu" else kernel
    return _KernelCall.apply(run, plain, *args)
