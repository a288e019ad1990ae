"""The rank side of `test_torch_mesh_train.py` (and of the FSDP checks in
`test_torch_rm_train.py` and `test_torch_mesh.py`): what each spawned rank
runs.

Imports torch and the port only (spawned ranks import this module by name),
so the ranks start without JAX. Each function takes the test's data file
(`torch.save` of numpy arrays and state dicts) and returns this rank's
results as numpy arrays; the test modules hold them against the JAX package
and the unsharded port.
"""

import numpy as np
import torch
import torch.distributed as dist

from reflectionflow_tpu_torch.config import FluxDiTConfig, QwenLMConfig, QwenVLVisionConfig, TrainConfig
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel
from reflectionflow_tpu_torch.ops.quant import NF4Linear, QuantLinear
from reflectionflow_tpu_torch.parallel import collectives
from reflectionflow_tpu_torch.parallel.mesh import make_mesh, shard_batch
from reflectionflow_tpu_torch.parallel.specs import RowParallelLinear, fsdp_local_bytes, shard_dit_params
from reflectionflow_tpu_torch.rm_train import train as rt
from reflectionflow_tpu_torch.train.optim import flatten_tree
from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step


def _t(a):
    return torch.from_numpy(np.array(a))


def _adapters(arrays: dict) -> dict:
    return {n: {k: torch.nn.Parameter(_t(v)) for k, v in ab.items()} for n, ab in arrays.items()}


def _numpy(adapters: dict) -> dict:
    return {n: {k: v.detach().numpy().copy() for k, v in ab.items()} for n, ab in adapters.items()}


def train_step(data: dict, shape) -> dict:
    """One corrector step (sgd, the default clip) on a (data, model) mesh of
    `shape` from the test's DiT, adapters, t and noise, and this rank's data
    slice of the test's global batch (as `train(mesh=)` feeds the step)."""
    mesh = make_mesh(shape, ("data", "model"))
    dit = FluxDiT(FluxDiTConfig(**data["cfg"])).eval().requires_grad_(False)
    dit.load_state_dict({k: _t(v) for k, v in data["dit"].items()})
    shard_dit_params(dit, mesh)
    adapters = _adapters(data["adapters"])
    tcfg = TrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr = "sgd", data["lr"]
    optimizer = make_optimizer(tcfg)
    state = optimizer.init([t for ab in adapters.values() for t in ab.values()])
    step = make_train_step(dit, optimizer, alpha=data["alpha"], r=data["r"], mesh=mesh)
    batch = {k: _t(v) for k, v in data["batch"].items()}
    batch.update(shard_batch({k: batch[k] for k in ("x0", "cond", "txt", "pooled")}, mesh))
    collectives.reset_counts()
    adapters, _, metrics = step(adapters, state, batch, t=_t(data["t"]), noise=_t(data["noise"]))
    return {"adapters": _numpy(adapters), "metrics": {k: float(v) for k, v in metrics.items()},
            "counts": dict(collectives.COUNTS), "heads": dit.transformer_blocks[0].cfg.num_heads}


def _small_qwen(data: dict) -> QwenVLModel:
    model = QwenVLModel(QwenLMConfig(**data["lm_cfg"]), QwenVLVisionConfig(**data["vis_cfg"]))
    model.load_state_dict({k: _t(v) for k, v in data["qwen"].items()}, strict=True)
    return model.eval().requires_grad_(False)


def _rm_trainable(data: dict) -> dict:
    out = {}
    for key, value in data["trainable"].items():
        out[key] = _adapters(value) if isinstance(value, dict) else _t(value)
    return out


def rm_step(data: dict, sharded: bool) -> dict:
    """One reward-model step (btt, special pooling, the vision adapters) over
    a "data" mesh of every rank with the base sharded FSDP, or unsharded on
    this rank; the batch is the global one."""
    model = _small_qwen(data)
    mesh = make_mesh((dist.get_world_size(),), ("data",)) if sharded else None
    whole = fsdp_local_bytes(model.model) + fsdp_local_bytes(model.visual)
    opt = rt.make_rm_optimizer(lr=data["lr"], vision_lr=data["vision_lr"])
    trainable = _rm_trainable(data)
    step = rt.make_rm_train_step(model.model, opt, loss_type="btt", pooling="special",
                                 special_token_id=data["sp"], alpha=data["alpha"], r=data["r"],
                                 tower=model.visual, grid_thw=tuple(data["grid"]), mesh=mesh,
                                 quantize_base=data.get("quantize_base"), quantize_min_size=16)
    held = fsdp_local_bytes(model.model) + fsdp_local_bytes(model.visual)
    collectives.reset_counts()
    trainable, _, aux = step(trainable, opt.init(trainable), {k: _t(v) for k, v in data["batch"].items()})
    return {"trainable": {k: v.detach().numpy().copy() for k, v in flatten_tree(trainable).items()},
            "loss": float(aux["loss"]), "rewards_A": aux["rewards_A"].numpy(),
            "bytes": (held, whole), "counts": dict(collectives.COUNTS)}


def tp_quantized_forward(data: dict) -> dict:
    """The test's DiT in a pipeline cut over a (1, world) mesh, then
    `FluxPipeline.quantize` (W8A8, or NF4 MLPs with `dit_int4_mlp`) under it,
    and one forward on the test's inputs; with every quantized linear's
    codes, scales and cut."""
    from reflectionflow_tpu_torch.parallel.dryrun import tiny_pipeline

    pipe = tiny_pipeline("cpu")
    pipe.dit = FluxDiT(FluxDiTConfig(**data["cfg"])).eval().requires_grad_(False)
    pipe.dit.load_state_dict({k: _t(v) for k, v in data["dit"].items()})
    pipe.set_mesh(make_mesh((1, dist.get_world_size()), ("data", "model")))
    pipe.quantize(which=("dit",), int4=(), min_size=16, **data.get("quantize_kw", {}))
    collectives.reset_counts()
    with torch.no_grad():
        out = pipe.dit(**{k: _t(v) for k, v in data["inputs"].items()}, attn_impl="pallas")
    codes = {}
    for name, m in pipe.dit.named_modules():
        q = m.quant if isinstance(m, RowParallelLinear) else m
        if not isinstance(q, (QuantLinear, NF4Linear)) or name.endswith(".quant"):
            continue
        cut = getattr(m, "tp_cut", None)
        index = None if cut is None else np.arange(cut[1].start, cut[1].stop) if isinstance(cut[1], slice) \
            else cut[1].numpy()
        if isinstance(q, QuantLinear):
            codes[name] = {"kind": "int8", "act_quant": q.act_quant, "cut": None if cut is None else cut[0],
                           "index": index, "w_q": q.w_q[:q.w_scale.shape[0], :q.in_features].numpy().copy(),
                           "w_scale": q.w_scale.numpy().copy()}
        else:
            codes[name] = {"kind": "nf4", "cut": None if cut is None else cut[0], "index": index}
    return {"out": out.numpy(), "codes": codes, "counts": dict(collectives.COUNTS),
            "rope_layout": pipe.rope_layout}


def nf4_group_split(data: dict) -> str:
    """`quantize(dit_int4_mlp=True)` with groups that straddle the ranks'
    cut: the ValueError's message."""
    try:
        tp_quantized_forward(dict(data, quantize_kw={"dit_int4_mlp": True, "int4_group": data["bad_group"]}))
    except ValueError as e:
        return str(e)
    return ""


def run_world(device, data_path: str) -> dict:
    """Every check of one launch, by the names in the data file's "checks"."""
    torch.set_num_threads(1)
    data = torch.load(data_path, weights_only=False)
    out = {"rank": dist.get_rank()}
    for name, kind, arg in data["checks"]:
        fn = {"train": train_step, "rm": rm_step, "tp_quant": tp_quantized_forward,
              "nf4_split": nf4_group_split}[kind]
        out[name] = fn(data[name], *(() if arg is None else (arg,)))
    return out
