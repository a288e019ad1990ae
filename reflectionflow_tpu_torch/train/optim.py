"""Optimizers for the LoRA trainer, with optax's semantics, over lists of tensors.

Counterpart of the optax transformations `train/rectified_flow.py::
make_optimizer` builds in the JAX package: `optax.contrib.prodigy` (at the
arguments it passes: `safeguard_warmup=True`, betas (0.9, 0.999), eps 1e-8,
estim_lr0 1e-6), `optax.adamw`, `optax.sgd`, `optax.clip_by_global_norm`
chained before them, and `optax.MultiSteps` around the chain; and the
`optax.multi_transform` of the reward-model trainer's parameter groups
(`rm_train/train.py::make_rm_optimizer`). PyTorch has no Prodigy, so it is
written here from optax's update rule.

Each transformation has `init(params) -> state` and `update(grads, state,
params) -> (updates, state)`; states are dicts of fp32 tensors and ints (so
`torch.save` checkpoints them) and `apply_updates` adds the updates to the
parameters in place.
"""

from __future__ import annotations

import torch


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def apply_updates(params, updates) -> None:
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))


def _zeros(params):
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _decay_pow(decay: float, count: int) -> torch.Tensor:
    """decay ** count in fp32, as optax takes it (an fp32 power of the int32
    step count), not in Python's float64."""
    return torch.tensor(decay, dtype=torch.float32) ** count


class clip_by_global_norm:
    """Scale all updates by max_norm / global norm when that norm is at or
    above max_norm."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        g_norm = global_norm(grads)
        if bool(g_norm < self.max_norm):
            return list(grads), state
        return [(g / g_norm.to(g.dtype)) * self.max_norm for g in grads], state


class sgd:
    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def init(self, params):
        return {}

    def update(self, grads, state, params=None):
        return [-self.lr * g for g in grads], state


class adamw:
    """Adam moments with bias correction, decoupled weight decay, then -lr."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2, self.eps, self.wd = learning_rate, b1, b2, eps, weight_decay

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, grads, state, params):
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"])]
        nu = [(1 - b2) * g.square() + b2 * n for g, n in zip(grads, state["nu"])]
        c1, c2 = 1 - _decay_pow(b1, count), 1 - _decay_pow(b2, count)
        updates = [-self.lr * ((m / c1) / (torch.sqrt(n / c2) + self.eps) + self.wd * p)
                   for m, n, p in zip(mu, nu, params)]
        return updates, {"count": count, "mu": mu, "nu": nu}


class prodigy:
    """Prodigy (Mishchenko and Defazio, arXiv 2306.06101): Adam whose step
    size estim_lr is learned from the gradients' correlation with the distance
    travelled from the initial point, as `optax.contrib.prodigy`."""

    def __init__(self, learning_rate: float = 1.0, betas=(0.9, 0.999), beta3: float | None = None,
                 eps: float = 1e-8, estim_lr0: float = 1e-6, estim_lr_coef: float = 1.0,
                 weight_decay: float = 0.0, safeguard_warmup: bool = False):
        self.lr, (self.b1, self.b2) = learning_rate, betas
        self.b3 = self.b2 ** 0.5 if beta3 is None else beta3
        self.eps, self.lr0, self.coef = eps, estim_lr0, estim_lr_coef
        self.wd, self.safeguard = weight_decay, safeguard_warmup

    def init(self, params):
        dev = params[0].device
        return {"exp_avg": _zeros(params), "exp_avg_sq": _zeros(params),
                "grad_sum": _zeros(params), "params0": [p.detach().float().clone() for p in params],
                "estim_lr": torch.tensor(self.lr0, dtype=torch.float32, device=dev),
                "numerator_weighted": torch.zeros((), dtype=torch.float32, device=dev),
                "count": 0}

    def update(self, grads, state, params):
        b1, b2, b3, lr0 = self.b1, self.b2, self.b3, self.lr0
        count = state["count"] + 1
        estim_lr = state["estim_lr"]
        bc = ((1 - _decay_pow(b2, count)) ** 0.5) / (1 - _decay_pow(b1, count))
        dlr = estim_lr * self.lr * bc
        dg = [estim_lr * g for g in grads]
        numerator_acum = sum((g.float() * (p0 - p.float())).sum()
                             for g, p0, p in zip(grads, state["params0"], params))
        exp_avg = [b1 * ea + (1 - b1) * d for ea, d in zip(state["exp_avg"], dg)]
        exp_avg_sq = [b2 * eas + (1 - b2) * d * d for eas, d in zip(state["exp_avg_sq"], dg)]
        step = estim_lr if self.safeguard else dlr
        grad_sum = [b3 * s + step * d / lr0 for s, d in zip(state["grad_sum"], dg)]
        numerator = b3 * state["numerator_weighted"] + (estim_lr / lr0) * dlr * numerator_acum
        denominator = sum(s.abs().sum() for s in grad_sum)
        new_lr = torch.maximum(estim_lr, self.coef * numerator / denominator)
        updates = [-self.wd * dlr * p - dlr * ea / (torch.sqrt(eas) + new_lr * self.eps)
                   for ea, eas, p in zip(exp_avg, exp_avg_sq, params)]
        return updates, {"exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq, "grad_sum": grad_sum,
                         "params0": state["params0"], "estim_lr": new_lr,
                         "numerator_weighted": numerator, "count": count}


class chain:
    def __init__(self, *transforms):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, grads, state, params=None):
        new_state = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state


class MultiSteps:
    """Average `every_k` consecutive gradients and pass the mean to the inner
    transformation on every k-th call; the calls between return zero updates
    and leave the inner state as it was (optax.MultiSteps, use_grad_mean)."""

    def __init__(self, opt, every_k_schedule: int):
        self.opt, self.k = opt, every_k_schedule

    def init(self, params):
        return {"mini_step": 0, "gradient_step": 0, "inner_opt_state": self.opt.init(params),
                "acc_grads": _zeros(params)}

    def update(self, grads, state, params=None):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(grads, state["acc_grads"])]
        if n < self.k - 1:
            return ([torch.zeros_like(a) for a in acc],
                    dict(state, mini_step=n + 1, acc_grads=acc))
        updates, inner = self.opt.update(acc, state["inner_opt_state"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner_opt_state": inner, "acc_grads": _zeros(acc)}


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict of tensors -> {"a/b/c": tensor}, in the dict's order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "/"))
        else:
            out[path] = v
    return out


class multi_transform:
    """optax.multi_transform over a nested dict of tensors: `label_fn(path)`
    ("lora/layers.0.self_attn.q_proj/lora_A", ...) names the transformation
    each tensor belongs to; each transformation sees only its own tensors and
    keeps its own state. `update` takes grads and params as nested or flat
    dicts and returns the updates as a flat {path: update} dict."""

    def __init__(self, transforms: dict, label_fn):
        self.transforms, self.label_fn = transforms, label_fn

    def _groups(self, params: dict) -> dict:
        flat = flatten_tree(params)
        groups = {k: [] for k in self.transforms}
        for path in flat:
            label = self.label_fn(path)
            if label not in groups:
                raise KeyError(f"{path}: label {label!r} has no transformation")
            groups[label].append(path)
        return groups

    def init(self, params: dict):
        flat = flatten_tree(params)
        return {k: self.transforms[k].init([flat[p] for p in paths]) for k, paths in self._groups(params).items()}

    def update(self, grads: dict, state, params: dict):
        flat_g, flat_p = flatten_tree(grads), flatten_tree(params)
        updates, new_state = {}, {}
        for k, paths in self._groups(params).items():
            u, new_state[k] = self.transforms[k].update([flat_g[p] for p in paths], state[k],
                                                        [flat_p[p] for p in paths])
            updates.update(zip(paths, u))
        return updates, new_state
