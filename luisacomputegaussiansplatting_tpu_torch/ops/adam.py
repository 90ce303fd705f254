"""Adam with its update as one hand-written CUDA kernel (K7, ``csrc/adam.cu``).

:class:`Adam` is a ``torch.optim.Adam`` that the trainer builds with one
parameter group per ``GaussianParams`` field (``models/trainer.py``). Its
state is torch's: ``param_groups`` with ``lr``, ``betas`` and ``eps``, and
``state[p]`` with ``step`` (a CPU tensor), ``exp_avg`` and ``exp_avg_sq``,
made at a parameter's first update; density control's moment surgery and
the checkpoints read and write it as they do torch's.

The path follows the parameters' device: when any parameter with a
gradient is a CUDA tensor, :meth:`Adam.step` updates them all (at most
MAX_TENSORS, float32, on one device, or :func:`adam_kernel` raises) with
one launch of K7, one pass over each element in place of torch's seven
foreach passes, rounding as torch's foreach kernels do; otherwise (CPU
tensors, the CPU tests) it is torch's own update. It replaces no TPU kernel: the JAX package's optimizer is
optax's Adam, which XLA fuses.

While a profiler records, the step runs in torch's range
``Optimizer.step#Adam.step`` and counts ``adam.kernel_elements``, the
elements K7 updated (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelLib, require_cuda_tensors
from ..utils.profiling import count

KERNEL = KernelLib("adam", {
    "adam_launch": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]),
})

#: parameters one launch takes (``kMaxTensors`` in ``csrc/adam.cu``); the
#: trainer's optimizer has six
MAX_TENSORS = 16

#: torch.optim.Adam's options that this class keeps at their defaults
_DEFAULTS = {"amsgrad": False, "weight_decay": 0, "maximize": False,
             "foreach": None, "capturable": False, "differentiable": False,
             "fused": None, "decoupled_weight_decay": False}


def _check(params, grads, exp_avgs, exp_avg_sqs, hyper) -> None:
    """What the kernel takes; raises before anything is built."""
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)
            == len(hyper)):
        raise ValueError("adam_kernel: expected one gradient, two moments "
                         "and one hyper-parameter tuple a parameter")
    if len(params) > MAX_TENSORS:
        raise ValueError(f"adam_kernel: at most {MAX_TENSORS} parameters a "
                         f"launch, got {len(params)}")
    tensors = [*params, *grads, *exp_avgs, *exp_avg_sqs]
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"adam_kernel: expected float32 tensors, got "
                             f"{t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError("adam_kernel: expected 16-byte aligned tensors")
    for quad in zip(params, grads, exp_avgs, exp_avg_sqs):
        if len({tuple(t.shape) for t in quad}) != 1:
            raise ValueError(f"adam_kernel: a parameter, its gradient and "
                             f"moments differ in shape: "
                             f"{[tuple(t.shape) for t in quad]}")
    for h in hyper:
        if len(h) != 6:
            raise ValueError("adam_kernel: expected six hyper-parameters a "
                             "parameter")
    if tensors:
        require_cuda_tensors("adam_kernel", *tensors)


def adam_kernel(params, grads, exp_avgs, exp_avg_sqs, hyper) -> None:
    """Launch K7 once over lists of at most MAX_TENSORS contiguous,
    16-byte aligned float32 CUDA tensors on one device, on its current stream, updating
    ``params``, ``exp_avgs`` and ``exp_avg_sqs`` in place. ``hyper`` holds
    per parameter (-lr / bc1, sqrt(bc2), 1 - beta1, beta2, 1 - beta2, eps),
    rounded to float32."""
    _check(params, grads, exp_avgs, exp_avg_sqs, hyper)
    if not params:
        return
    k = len(params)
    ptrs = (ctypes.c_int64 * (4 * k))(*(
        t.data_ptr() for quad in zip(params, grads, exp_avgs, exp_avg_sqs)
        for t in quad))
    sizes = (ctypes.c_int64 * k)(*(p.numel() for p in params))
    scalars = (ctypes.c_float * (6 * k))(*(x for h in hyper for x in h))
    lib = KERNEL.lib()
    dev = params[0].device
    with torch.cuda.device(dev):
        err = lib.adam_launch(k, ptrs, sizes, scalars,
                              torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(err, "adam_launch")
    KERNEL.launched()


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` with a learning rate, betas and eps (per group)
    and none of its other options, whose update of CUDA parameters is
    K7."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        changed = {k: group[k] for k, v in _DEFAULTS.items()
                   if k in group and group[k] != v}
        if changed:
            raise ValueError(f"Adam: options {changed} are not supported")
        if any(torch.is_tensor(x) for x in (group["lr"], *group["betas"])):
            raise ValueError("Adam: a tensor lr or betas is not supported")

    @torch.no_grad()
    def step(self, closure=None):
        work = [(group, p) for group in self.param_groups
                for p in group["params"] if p.grad is not None]
        if not any(p.is_cuda for _, p in work):
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        args = ([], [], [], [], [])
        for group, p in work:
            if p.grad.is_sparse:
                raise RuntimeError("Adam does not support sparse gradients")
            st = self.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            st["step"] += 1
            t = st["step"].item()
            beta1, beta2 = group["betas"]
            # torch's non-capturable foreach path, in double
            bc1 = 1 - beta1 ** t
            bc2 = 1 - beta2 ** t
            hyper = ((group["lr"] / bc1) * -1, bc2 ** 0.5, 1 - beta1, beta2,
                     1 - beta2, group["eps"])
            for out, x in zip(args, (p, p.grad, st["exp_avg"],
                                     st["exp_avg_sq"], hyper)):
                out.append(x)
        adam_kernel(*args)
        count("adam.kernel_elements", sum(p.numel() for _, p in work))
        return loss
