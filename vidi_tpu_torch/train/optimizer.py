"""AdamW with the reference's parameter groups and freeze masks (port of
vidi_tpu/train/optimizer.py).

The JAX module builds its optimizer from optax, which the port does not
use; this module restates the same groups, schedule and arithmetic in
plain torch:
- groups {base, mm_rand, mm_vis, mm_aud} x {decay, nodecay} with per-module
  learning rates, and "frozen" for modules that do not train (no state, no
  update);
- per step, on fp32 grads g of fp32 params p: optional clip by global norm,
  mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2 in fp32,
  u = mu_hat / (sqrt(nu_hat) + eps) with bias correction at count + 1,
  plus wd * p on decay groups, times schedule(count) (count from 0), then
  negated: optax's scale_by_adam -> add_decayed_weights -> scale_by_schedule
  -> scale(-1).
`torch.optim.AdamW` does not qualify: it keeps its moments in the parameter
dtype (bf16 here), which is not JAX's arithmetic. The moments are updated
in place, and `apply` writes the parameters in place. `MultiSteps` adds
gradient accumulation (optax.MultiSteps).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    learning_rate: float = 1e-5
    mm_rand_lr: Optional[float] = 2e-5
    mm_vis_lr: Optional[float] = None
    mm_aud_lr: Optional[float] = None
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    train_rand: bool = True
    train_vis: bool = False
    train_aud: bool = False
    train_llm: bool = True
    grad_clip: Optional[float] = None


def leaves(tree, path: Tuple = ()) -> Iterator[Tuple[str, Tuple, torch.Tensor]]:
    """(key, path, tensor) of every leaf of a parameter tree (dicts, and
    lists for per-layer params); key is the path joined by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield "/".join(map(str, path)), path, tree


def _module_of(path) -> str:
    return {"text": "base", "vision": "mm_vis", "audio": "mm_aud", "mm": "mm_rand"}[path[0]]


def _is_no_decay(path, leaf) -> bool:
    """Norm weights and 1-D tensors get no weight decay. The rank is the JAX
    tree's, which stacks each `layers` dict into [L, ...] leaves: a
    per-layer leaf counts one more dim (so a per-layer bias decays there)."""
    name = str(path[-1])
    ndim = leaf.dim() + ("layers" in path)
    return ndim <= 1 or "norm" in name.lower() or name in (
        "input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln", "final_ln")


def _trainable(module: str, hp: TrainHParams) -> bool:
    return {"base": hp.train_llm, "mm_rand": hp.train_rand,
            "mm_vis": hp.train_vis, "mm_aud": hp.train_aud}[module]


def param_labels(params, hp: TrainHParams) -> Dict[str, str]:
    """key -> "frozen" or "<module>_<decay|nodecay>" for every leaf."""
    out = {}
    for key, path, leaf in leaves(params):
        mod = _module_of(path)
        if not _trainable(mod, hp):
            out[key] = "frozen"
        else:
            out[key] = f"{mod}_{'nodecay' if _is_no_decay(path, leaf) else 'decay'}"
    return out


def lr_schedule(hp: TrainHParams, lr: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), 0) with warmup = max(int(total * warmup_ratio), 1): linear
    from 0 over the warmup, then cosine down to 0."""
    warmup = max(int(hp.total_steps * hp.warmup_ratio), 1)
    decay_steps = max(hp.total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * max(count, 0) / warmup
        c = min(count - warmup, decay_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return schedule


class AdamW:
    """The optax chain of `vidi_tpu.train.optimizer.make_optimizer`.

    State: {"count": int, "mu": {key: fp32}, "nu": {key: fp32}} over the
    trainable leaves."""

    def __init__(self, labels: Dict[str, str], hp: TrainHParams,
                 lr_fn: Optional[Callable[[int], float]] = None):
        """`lr_fn` (count -> rate) serves every group in place of the
        warmup-cosine schedules."""
        self.labels, self.hp = labels, hp
        lrs = {"base": hp.learning_rate,
               "mm_rand": hp.mm_rand_lr or hp.learning_rate,
               "mm_vis": hp.mm_vis_lr or hp.learning_rate,
               "mm_aud": hp.mm_aud_lr or hp.learning_rate}
        self.schedules = {mod: lr_fn or lr_schedule(hp, lr) for mod, lr in lrs.items()}

    def init(self, params) -> Dict:
        """Zero fp32 moments for every trainable leaf."""
        zeros = {key: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for key, _, p in leaves(params) if self.labels[key] != "frozen"}
        return {"count": 0, "mu": zeros,
                "nu": {k: torch.zeros_like(v) for k, v in zeros.items()}}

    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params
               ) -> Dict[str, torch.Tensor]:
        """-> {key: fp32 update to add to the fp32 param}, as optax's
        `update(grads, state, params32)`; advances `state` in place."""
        return {key: u for key, _, u in self._updates(grads, state, params)}

    @torch.no_grad()
    def apply(self, params, grads: Dict[str, torch.Tensor], state: Dict) -> None:
        """One step in place: p <- (fp32(p) + update) cast back to p's dtype,
        one leaf at a time (no full fp32 copy of the tree)."""
        for _, p, u in self._updates(grads, state, params):
            p.copy_(p.float().add_(u))

    def _updates(self, grads, state, params):
        """Yield (key, param, fp32 update) per trainable leaf, then advance
        the count."""
        hp = self.hp
        clip = None
        if hp.grad_clip:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
            if not bool(norm < hp.grad_clip):
                clip = hp.grad_clip / norm
        count = state["count"]
        bc1, bc2 = 1.0 - hp.beta1 ** (count + 1), 1.0 - hp.beta2 ** (count + 1)
        lrs = {mod: fn(count) for mod, fn in self.schedules.items()}
        for key, path, p in leaves(params):
            label = self.labels[key]
            if label == "frozen":
                continue
            g = grads[key].float()
            if clip is not None:
                g = g * clip
            mu, nu = state["mu"][key], state["nu"][key]
            mu.mul_(hp.beta1).add_(g, alpha=1.0 - hp.beta1)
            nu.mul_(hp.beta2).addcmul_(g, g, value=1.0 - hp.beta2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(hp.eps))
            if label.endswith("_decay"):
                u.add_(p.float(), alpha=hp.weight_decay)
            u.mul_(-lrs[_module_of(path)])
            yield key, p, u
        state["count"] = count + 1


class MultiSteps:
    """Gradient accumulation over k micro-steps: the counterpart of
    `optax.MultiSteps(tx, k)` with its default `use_grad_mean`, as the JAX
    CLI wraps its optimizer. Each micro-step folds its gradients into fp32
    running means, acc += (g - acc) / (mini_step + 1) (optax's Welford
    form, in its order of operations); the k-th applies the inner AdamW to
    the means and zeroes them, and the micro-steps in between leave the
    parameters untouched. The inner schedules count optimizer steps.

    State: {"mini_step": int, "gradient_step": int, "acc": {key: fp32},
    "inner": the inner state}, accumulators for the trainable leaves only."""

    def __init__(self, inner: AdamW, k: int):
        if k < 1:
            raise ValueError(f"gradient accumulation needs k >= 1, got {k}")
        self.inner, self.k = inner, k
        self.labels = inner.labels

    def init(self, params) -> Dict:
        inner = self.inner.init(params)
        return {"mini_step": 0, "gradient_step": 0, "inner": inner,
                "acc": {key: torch.zeros_like(m) for key, m in inner["mu"].items()}}

    @torch.no_grad()
    def apply(self, params, grads: Dict[str, torch.Tensor], state: Dict) -> None:
        n = state["mini_step"]
        for key, acc in state["acc"].items():
            acc.add_((grads[key].float() - acc) / (n + 1))
        if n == self.k - 1:
            self.inner.apply(params, state["acc"], state["inner"])
            for acc in state["acc"].values():
                acc.zero_()
            state["gradient_step"] += 1
        state["mini_step"] = (n + 1) % self.k


def adamw(params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> AdamW:
    """optax.adamw(lr) with its defaults: every leaf trains and decays, at
    a constant rate (the distillation student's optimizer)."""
    hp = TrainHParams(weight_decay=weight_decay, beta1=b1, beta2=b2, eps=eps)
    return AdamW({key: f"{_module_of(path)}_decay" for key, path, _ in leaves(params)}, hp,
                 lr_fn=lambda count: lr)


def make_optimizer(params, hp: TrainHParams, grad_accum: int = 1):
    """AdamW over the parameter groups; `grad_accum` > 1 wraps it in
    `MultiSteps`."""
    tx = AdamW(param_labels(params, hp), hp)
    return MultiSteps(tx, grad_accum) if grad_accum > 1 else tx
