"""Optimizer and LR schedule, counterpart of dd3d_tpu/training/optim.py:
SGD with momentum, weight decay masked off the norm affines
(WEIGHT_DECAY_NORM == 0), WarmupMultiStepLR, and clipping by value or by
the global norm.

`torch.optim.SGD` with two param groups (decayed, not decayed) gives the
update of the JAX package's fused_sgd (optax's trace convention,
m = g + mu * m, update = m, or g + mu * m with Nesterov): its first
momentum buffer is the gradient itself, and its weight decay is added to
the (clipped) gradient before the momentum, as optax's chain does. The lr
of a step is the schedule at the count BEFORE the step. The mask is
computed from each parameter's flax path (utils/convert_checkpoint.py),
the names JAX's `_wd_mask` reads.

SOLVER.ACCUMULATE_GRAD_BATCHES = k > 1 is JAX's optax.MultiSteps
(dd3d_tpu/training/optim.py:142-143): the update applies the mean of k
micro-batch gradients (the train step scales each backward by 1/k and the
gradients add up in .grad), once every k micro-batches; `count`, and with
it the schedule, advances only on an applied update. `mini_step` counts the
micro-batches taken since the last one.
"""
from typing import Dict, List, Sequence

import torch

from dd3d_tpu_torch.utils.convert_checkpoint import flax_param_paths


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                              warmup_factor: float = 1e-4, warmup_iters: int = 2000,
                              warmup_method: str = "linear"):
    """d2 WarmupMultiStepLR: lr(count) = base * warmup(count) * gamma^k."""
    steps = tuple(int(s) for s in steps)
    if warmup_method not in ("linear", "constant"):
        raise ValueError(warmup_method)

    def schedule(count: int) -> float:
        if count < warmup_iters:
            if warmup_method == "linear":
                alpha = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
                warm = warmup_factor * (1 - alpha) + alpha
            else:
                warm = warmup_factor
        else:
            warm = 1.0
        return base_lr * warm * gamma ** sum(count >= s for s in steps)

    return schedule


def weight_decay_mask(model: torch.nn.Module, weight_decay_norm_is_zero: bool) -> Dict[str, bool]:
    """{parameter name: decayed}: a parameter is excluded when any element of
    its flax path starts with "norm" and WEIGHT_DECAY_NORM is 0 (JAX
    optim.py:45-55)."""
    return {name: not (weight_decay_norm_is_zero and any(p.startswith("norm") for p in path))
            for name, path in flax_param_paths(model).items()}


class Optimizer:
    """SGD + schedule + clipping over a model's parameters. `count` is the
    number of steps taken (the schedule's input); `step()` reads the
    parameters' .grad and never syncs with the host."""

    mini_step = 0  # micro-batches since the last applied update

    def __init__(self, cfg, model: torch.nn.Module):
        sol = cfg.SOLVER
        self.accumulate = int(sol.get("ACCUMULATE_GRAD_BATCHES", 1))
        if self.accumulate < 1:
            raise ValueError(f"SOLVER.ACCUMULATE_GRAD_BATCHES={self.accumulate}")
        self.mini_step = 0
        self.schedule = warmup_multistep_schedule(sol.BASE_LR, sol.STEPS, sol.GAMMA, sol.WARMUP_FACTOR,
                                                  sol.WARMUP_ITERS, sol.WARMUP_METHOD)
        self.clip_value = self.clip_norm = 0.0
        if sol.CLIP_GRADIENTS.ENABLED:
            if sol.CLIP_GRADIENTS.CLIP_TYPE == "value":
                self.clip_value = float(sol.CLIP_GRADIENTS.CLIP_VALUE)
            else:
                self.clip_norm = float(sol.CLIP_GRADIENTS.CLIP_VALUE)
        mask = weight_decay_mask(model, sol.WEIGHT_DECAY_NORM == 0.0)
        named = dict(model.named_parameters())
        self.params: List[torch.nn.Parameter] = list(named.values())
        groups = [
            {"params": [p for n, p in named.items() if mask[n]], "weight_decay": float(sol.WEIGHT_DECAY)},
            {"params": [p for n, p in named.items() if not mask[n]], "weight_decay": 0.0},
        ]
        self.sgd = torch.optim.SGD([g for g in groups if g["params"]], lr=self.schedule(0),
                                   momentum=float(sol.MOMENTUM), nesterov=bool(sol.NESTEROV), foreach=True)
        self.count = 0

    def step(self) -> None:
        grads = []
        for p in self.params:
            if p.grad is None:  # a parameter the loss does not reach still decays, as in JAX
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.clip_value > 0.0:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        if self.clip_norm > 0.0:
            scale = torch.clamp(self.clip_norm / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)
        lr = self.schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def state_dict(self):
        """The SGD state and count, and between two applied updates the
        micro-batch count and the gradients accumulated so far (optax keeps
        them in MultiSteps' state)."""
        state = {"sgd": self.sgd.state_dict(), "count": self.count, "mini_step": self.mini_step}
        if self.mini_step:
            state["acc_grads"] = [None if p.grad is None else p.grad.detach().clone() for p in self.params]
        return state

    def load_state_dict(self, state) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        if "acc_grads" in state:
            for p, g in zip(self.params, state["acc_grads"]):
                p.grad = None if g is None else g.to(p.device)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all elements of all tensors, in f32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))
