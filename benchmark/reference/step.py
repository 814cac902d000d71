"""The plain reference of the s2ag GAN training step (reference
processor_v2.py:776-957, `forward_pass_s2ag`): one D update, then one G
update (Huber + KLD + diversity regularizer + ns-GAN), Adam with betas
(0.5, 0.999), in plain PyTorch, float32 with TF32 off, on the nets of
`nets.py`. It imports nothing of the program under test.

`follow` runs the first steps of a run from the benchmark's weights, rows
and seed, and records what the comparison reads: each step's losses, each
net's first gradient as its Adam holds it after one step (or its first
moment after the steps), and each parameter's change over the steps.

`precision` "tf32" and "fp8" are the controls: the same step computed in
the precision below the one a configuration states (TF32 products for a
float32 step; for a bf16 mixed-precision step, every parameter, every
net's input and every module's output rounded to float8 e4m3 with a
per-tensor scale, and the recurrence's projections and state at every
step). `fraction` < 1 is a fault: the step on the first rows of each batch
alone, the losses their mean."""

from __future__ import annotations

import contextlib

import torch

from . import nets as N


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude at 448), the gradient passed straight through."""
    if not x.is_floating_point():
        return x
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


@contextlib.contextmanager
def precision(mode: str, modules=()):
    """The block's arithmetic: "f32" (TF32 off), "tf32", or "fp8" (TF32
    off, every module's output and the recurrence rounded by `fp8_round`;
    parameters and inputs by `call`)."""
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    hooks = []
    if mode == "fp8":
        N.Precision.round = fp8_round

        def out_hook(module, args, out):
            return fp8_round(out) if isinstance(out, torch.Tensor) else out

        for m in modules:
            hooks += [sub.register_forward_hook(out_hook) for sub in m.modules()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        N.Precision.round = None
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def call(net, *args, **kwargs):
    """net(*args, **kwargs); under the fp8 control with its parameters and
    float inputs rounded."""
    rnd = N.Precision.round
    if rnd is None:
        return net(*args, **kwargs)
    swapped = []
    try:
        for m in net.modules():
            for name, p in m._parameters.items():
                if p is not None:
                    swapped.append((m, name, p))
                    m._parameters[name] = rnd(p)
        return net(*[rnd(a) if isinstance(a, torch.Tensor) else a for a in args], **kwargs)
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


# ------------------------------------------------------------------ losses
def smooth_l1(x, y):
    d = x - y
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def gan_losses():
    eps = 1e-8
    return (lambda r, f: -torch.mean(torch.log(r + eps) + torch.log(1.0 - f + eps)),
            lambda f: -torch.mean(torch.log(f + eps)))


def decode(raw: dict, idx: torch.Tensor, adv: torch.Tensor) -> dict:
    """A batch of the packed rows `idx` (int16 audio rescaled by its row's
    maximum in float32, float16 MFCCs promoted), the speakers `adv`."""
    return {"text": raw["words"][idx].long(), "target": raw["poses"][idx],
            "mfcc": raw["mfcc"][idx].float(), "vids": adv,
            "audio": raw["audio"][idx].float() * raw["audio_max"][idx, None] / 32767.0}


def build_pre_seq(target, n_pre):
    b, t, _ = target.shape
    mask = (torch.arange(t, device=target.device) < n_pre).to(target.dtype)
    return torch.cat([target, target.new_ones(b, t, 1)], dim=-1) * mask[None, :, None]


def train_step(gen, dis, tri, opts, batch, m: dict, generator) -> dict:
    """One GAN step with the GAN terms on; the metrics under the program's
    names."""
    dis_loss_fn, gen_gan_fn = gan_losses()
    gen.train()
    dis.train()
    text, target, mfcc, vids = batch["text"], batch["target"], batch["mfcc"], batch["vids"]
    pre = build_pre_seq(target, m["n_pre_poses"])
    N.Draws.generator = generator
    out = {}
    # D update
    with torch.no_grad():
        fake = call(gen, pre, text, mfcc, vids)[0]
    d_loss = dis_loss_fn(call(dis, target), call(dis, fake))
    opts[1].zero_grad(set_to_none=True)
    d_loss.backward()
    opts[1].step()
    out["dis"] = d_loss.detach()
    # G update
    g_out, z, mu, log_var = call(gen, pre, text, mfcc, vids)
    huber = smooth_l1(g_out / 0.1, target / 0.1).mean() * 0.1
    loss = m["loss_regression_weight"] * huber
    out["loss"] = loss.detach()
    perm = torch.randperm(vids.shape[0], generator=generator, device=generator.device)
    rand_vids = vids[perm.to(vids.device)]
    with torch.no_grad():
        out_rand, z_rand = call(gen, pre, text, mfcc, rand_vids)[:2]
    pose_l1 = (smooth_l1(g_out / 0.05, out_rand / 0.05) * 0.05).sum(dim=(1, 2))
    z_l1 = (z.detach() - z_rand).abs().reshape(z.shape[0], -1).mean(dim=1)
    div_reg = m["loss_reg_weight"] * torch.clamp(-(pose_l1 / (z_l1 + 1.0e-5)), min=-1000.0).mean()
    loss = loss + div_reg
    out["DIV_REG"] = div_reg.detach()
    kld = m["loss_kld_weight"] * -0.5 * torch.mean(1.0 + log_var - mu ** 2 - torch.exp(log_var))
    loss = loss + kld
    out["KLD"] = kld.detach()
    dis.requires_grad_(False)
    gen_err = m["loss_gan_weight"] * gen_gan_fn(call(dis, g_out))
    dis.requires_grad_(True)
    loss = loss + gen_err
    out["gen"] = gen_err.detach()
    opts[0].zero_grad(set_to_none=True)
    loss.backward()
    opts[0].step()
    out["g_total"] = loss.detach()
    g_out = g_out.detach()
    s2ag_l1 = (g_out - target).abs().mean()
    with torch.no_grad():
        tri_out = call(tri.train(), pre, text, batch["audio"], vids)[0]
    out["s2ag_vs_trimodal_l1"] = s2ag_l1 - (tri_out - target).abs().mean()
    out["s2ag_l1"] = s2ag_l1
    return out


def leaf_norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named}


def follow(config_dims: dict, weights: dict, raw: dict, draws: list, seed: int, device,
           n_steps: int, first_grad: bool, mode: str = "f32", fraction: float = 1.0) -> dict:
    """The first `n_steps` steps of a run on the rows and speakers `draws`
    [(idx, adv), ...] (device tensors, the global batch), the dropout masks
    and noise from a generator on `device` seeded with `seed`. Returns
    {"losses": [{name: value}] a step, "grad": {leaf: norm} (each net's
    gradient as Adam holds it after one step with `first_grad`, else its
    first moment after the steps), "delta": {leaf: norm of the change}}."""
    m = config_dims
    gen, dis, tri = N.build(m)
    for net, prefix in ((gen, "gen."), (dis, "dis."), (tri, "tri.")):
        net.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                             if k.startswith(prefix)})
        net.to(device)
    tri.requires_grad_(False)
    beta1, beta2 = m["adam_betas"]
    opts = (torch.optim.Adam(gen.parameters(), lr=m["learning_rate"], betas=(beta1, beta2),
                             foreach=False),
            torch.optim.Adam(dis.parameters(), lr=m["learning_rate"] * m["discriminator_lr_weight"],
                             betas=(beta1, beta2), foreach=False))
    start = {f"{p}.{k}": v.detach().clone() for p, net in (("gen", gen), ("dis", dis))
             for k, v in net.named_parameters()}
    generator = torch.Generator(device=device).manual_seed(seed)
    losses, grad = [], None

    def moments():
        return leaf_norms((f"{p}.{k}", opt.state[v]["exp_avg"] / (1.0 - beta1))
                          for p, net, opt in (("gen", gen, opts[0]), ("dis", dis, opts[1]))
                          for k, v in net.named_parameters() if v in opt.state)

    with precision(mode, (gen, dis, tri)):
        for step in range(n_steps):
            idx, adv = draws[step]
            if fraction < 1.0:
                keep = int(len(idx) * fraction)
                idx, adv = idx[:keep], adv[:keep]
            metrics = train_step(gen, dis, tri, opts, decode(raw, idx, adv), m, generator)
            losses.append({k: float(v) for k, v in metrics.items()})
            if step == 0 and first_grad:
                grad = moments()
    if grad is None:
        grad = moments()
    delta = leaf_norms((k, v - start[k]) for p, net in (("gen", gen), ("dis", dis))
                       for k, v in ((f"{p}.{n}", t) for n, t in net.named_parameters()))
    N.Draws.generator = None
    return {"losses": losses, "grad": grad, "delta": delta}
