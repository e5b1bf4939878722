"""Where the one-rank FSDP train step first departs from the plain one.

    python -m torch.distributed.run --standalone --nproc_per_node=1 \\
        scripts/probe_torch_fsdp_parity.py [--steps 4] [--device cpu --config PATH]

Builds the train CLI's model for ``synthetic_flagship.json`` (cifar10_cond's
UNet, bf16, dropout off, cuDNN's autotuner off, as chip_smoke's dist phase
runs it) from one seed and trains it on the same synthetic batches and draws
in five runs, one after another in this process: plain, FSDP2 at world size
1, plain again (is the plain run its own twin?), FSDP with every conv and
linear weight and bias copied into a fresh allocation at its call (do the
all-gathered parameters' views change those calls' arithmetic?), and plain
with the identity autograd nodes that FSDP2 puts on each unit's inputs
(``RegisterPostBackwardFunction``) and nothing else of it (does the graph's
shape alone change the order in which the backward sums a tensor's
gradients?). Every step
is taken apart at its stages, and each stage of a run is held against the
first plain run's: the loss, the pre-clip gradients, the clip's global norm,
the clipped gradients, the parameters after AdamW and the EMA. One line per
run and step gives, for each stage, "=" (bit for bit) or the largest
difference over the largest value of the plain run's tensors.

It also records every ``F.conv2d`` and ``F.linear`` call of the first
step's forward (the weight's and the input's dtype, strides and pointer
offset modulo 256 bytes, and the bias's offset) and prints the calls whose
record differs from the plain run's. ``--grad-norm 0`` turns the clip off.
"""

import argparse
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch import train_lib  # noqa: E402
from vdiff_tpu_torch.data import DATA_INFO, get_dataloader  # noqa: E402
from vdiff_tpu_torch.factory import (CONFIG_DIR, DEFAULT_CONFIG_PATH,  # noqa: E402
                                     build_diffusion, build_unet, load_experiment_config)
from vdiff_tpu_torch.parallel import init_distributed  # noqa: E402

FLAGSHIP = os.path.join(CONFIG_DIR, "synthetic_flagship.json")
STAGES = ("loss", "grads", "norm", "clipped", "params", "ema")
LAYOUT_FIELDS = ((3, "weight strides"), (4, "weight offsets"), (6, "input strides"),
                 (7, "input offsets"), (8, "bias offsets"))


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


class CallLog:
    """Records the layout of each F.conv2d / F.linear call while ``on``;
    with ``fresh``, every call gets its weight and bias as fresh copies."""

    def __init__(self, fresh=False):
        self.calls, self.on, self.fresh = [], False, fresh
        self._conv, self._linear = F.conv2d, F.linear

        def record(name, orig):
            def fn(x, w, b=None, *a, **k):
                if self.on:
                    self.calls.append((name, tuple(w.shape), w.dtype, w.stride(),
                                       w.data_ptr() % 256, x.dtype, x.stride(),
                                       x.data_ptr() % 256,
                                       None if b is None else b.data_ptr() % 256))
                if self.fresh:
                    w, b = w.clone(), None if b is None else b.clone()
                return orig(x, w, b, *a, **k)
            return fn

        F.conv2d, F.linear = record("conv2d", self._conv), record("linear", self._linear)

    def restore(self):
        F.conv2d, F.linear = self._conv, self._linear


class _Identity(torch.autograd.Function):
    """FSDP2's ``RegisterPostBackwardFunction`` without its post-backward:
    the inputs pass through one autograd node, the gradients back."""

    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *grads):
        return grads


def _identity_nodes(module):
    """Route the tensor inputs of ``module`` that need a gradient through one
    :class:`_Identity` node a call, as FSDP2's pre-forward does."""
    def hook(mod, args, kwargs):
        flat = [a for a in list(args) + list(kwargs.values())
                if torch.is_tensor(a) and a.requires_grad]
        if not flat:
            return None
        through = iter(_Identity.apply(*flat))
        swap = {id(a): next(through) for a in flat}
        return (tuple(swap.get(id(a), a) for a in args),
                {k: swap.get(id(v), v) for k, v in kwargs.items()})
    module.register_forward_pre_hook(hook, with_kwargs=True)


def run(args, config, batches, device, log, fsdp=False, identities=False):
    diffusion, timesteps = build_diffusion(config["diffusion"], w_guide=config["conditional"][
        "w_guide"], p_uncond=config["conditional"]["p_uncond"])
    info = DATA_INFO[config["data"]["name"]]
    model = build_unet(config["model"], in_channels=info["channels"],
                       model_out_type=config["diffusion"]["model_out_type"],
                       num_classes=info.get("num_classes", 0), multitags=False,
                       dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                       generator=torch.Generator().manual_seed(config["train"]["seed"]),
                       model_var_type=config["diffusion"]["model_var_type"])
    tr = config["train"]
    trainer = train_lib.Trainer(
        model, diffusion, timesteps, epochs=1, trainloader=None,
        optimizer_config=dict(lr=tr["lr"], beta1=tr["beta1"], beta2=tr["beta2"],
                              weight_decay=tr["weight_decay"], warmup=tr["warmup"]),
        use_cfg=True, use_ema=True, grad_norm=args.grad_norm, num_accum=1,
        shape=info["resolution"] + (info["channels"],), ema_decay=tr["ema_decay"],
        seed=tr["seed"], device=device, fsdp=fsdp)
    if identities:
        from vdiff_tpu_torch.parallel.fsdp import fsdp_units

        for unit in fsdp_units(trainer.module):
            _identity_nodes(unit)
    record = {"names": [n for n, _ in trainer.module.named_parameters()]}
    opt, clip = trainer.optimizer, train_lib.clip_by_global_norm_

    def recording_clip(grads, max_norm):
        norm = clip(grads, max_norm)
        record["norm"] = norm.detach().clone().reshape(1)
        record["clipped"] = [_full(g) for g in grads]
        return norm

    def recording_step(step=opt.step):
        record["grads"] = [_full(p.grad) for p in opt.params]
        record["norm"] = record["clipped"] = None
        step()

    opt.step = recording_step
    train_lib.clip_by_global_norm_ = recording_clip
    steps = []
    try:
        for i, (x, y) in enumerate(batches):
            log.on = i == 0
            loss = trainer.step(x, y)
            log.on = False
            record["loss"] = loss.detach().clone().reshape(1)
            record["params"] = [_full(p) for p in opt.params]
            record["ema"] = [_full(p) for p in trainer.ema_model.parameters()]
            if record["norm"] is None:  # no clip
                record["norm"] = torch.zeros(1, device=device)
                record["clipped"] = record["grads"]
            steps.append(dict(record))
    finally:
        train_lib.clip_by_global_norm_ = clip
    return steps


def _diff(a, b):
    """'=' when equal bit for bit, else max|a - b| / max|b| over the lists."""
    a, b = (a if isinstance(a, list) else [a]), (b if isinstance(b, list) else [b])
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        return "="
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
    top = max(y.float().abs().max().item() for y in b)
    n = sum(not torch.equal(x, y) for x, y in zip(a, b))
    return f"{err / top:.3e} ({n}/{len(b)} tensors)"


def _where(got, want, names):
    """The gradients that differ, by module (the name's first two parts):
    count and largest difference over that tensor's largest value."""
    groups = {}
    for g, w, n in zip(got, want, names):
        if not torch.equal(g, w):
            key = ".".join(n.split(".")[:2])
            rel = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            c, r = groups.get(key, (0, 0.0))
            groups[key] = (c + 1, max(r, rel))
    return "; ".join(f"{k} {c} ({r:.1e})" for k, (c, r) in groups.items())


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default=FLAGSHIP)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--grad-norm", type=float, default=None,
                   help="the clip's bound (default: the config's; 0 turns it off)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    device = init_distributed(args.device)
    config, _ = load_experiment_config(args.config, DEFAULT_CONFIG_PATH)
    config["model"]["drop_rate"] = 0.0
    if args.grad_norm is None:
        args.grad_norm = config["train"]["grad_norm"]
    torch.backends.cudnn.benchmark = False
    tf32 = bool(config.get("speedup", {}).get("allow_tf32"))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    loader, _ = get_dataloader(config["data"]["name"], batch_size=config["train"]["batch_size"],
                               split="train", random_seed=config["train"]["seed"], root="")
    loader.set_epoch(0)
    batches = [b for _, b in zip(range(args.steps), loader)]
    card = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    print(f"fsdp parity: {config['data']['name']}, B={config['train']['batch_size']}, "
          f"{args.steps} steps, grad_norm {args.grad_norm}, {card}", flush=True)
    logs = {}
    runs = {}
    for name, fsdp, fresh, identities in (
            ("plain", False, False, False), ("fsdp", True, False, False),
            ("plain again", False, False, False), ("fsdp, fresh copies", True, True, False),
            ("plain, FSDP's identity nodes", False, False, True)):
        logs[name] = CallLog(fresh)
        try:
            runs[name] = run(args, config, batches, device, logs[name], fsdp=fsdp,
                             identities=identities)
        finally:
            logs[name].restore()
        ref, where = runs["plain"], None
        for i, (got, want) in enumerate(zip(runs[name], ref)):
            print(f"{name} step {i}: " + ", ".join(f"{s} {_diff(got[s], want[s])}"
                                                    for s in STAGES), flush=True)
            if where is None and _diff(got["grads"], want["grads"]) != "=":
                where = f"step {i}: {_where(got['grads'], want['grads'], want['names'])}"
        if where:
            print(f"{name}: the first gradients that differ, by module, {where}", flush=True)
        if name.startswith("plain,"):
            fs = runs["fsdp"]
            print(f"{name} against fsdp: " + "; ".join(
                f"step {i} " + ", ".join(f"{s} {_diff(got[s], want[s])}" for s in STAGES)
                for i, (got, want) in enumerate(zip(runs[name], fs))), flush=True)
        if name != "plain":
            differ = [(k, a, b) for k, (a, b) in enumerate(zip(logs[name].calls,
                                                               logs["plain"].calls)) if a != b]
            fields = ", ".join(f"{label} {sum(a[i] != b[i] for _, a, b in differ)}"
                               for i, label in LAYOUT_FIELDS)
            print(f"{name}: {len(logs[name].calls)} conv/linear calls in step 0's forward, "
                  f"{len(differ)} with another layout than plain's ({fields})", flush=True)
            for k, a, b in differ[:4]:
                print(f"  call {k}: {a}\n     plain: {b}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
