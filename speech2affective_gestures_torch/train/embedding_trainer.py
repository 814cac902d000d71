"""Training of the FGD gesture-embedding autoencoder (the JAX package's
`train/embedding_trainer.py`): `EmbeddingNet(mode="pose")` as a
reconstruction autoencoder over pose windows, Adam at lr 5e-4 on the mean
Huber loss (delta 1) of the reconstruction, plus 0.1 KLD when variational.

The reference consumes a pre-trained `outputs/embedding_net.pth.tar` and
ships no code that makes one; this trainer makes one from any corpus. The
windows are staged on the device once and each step gathers its batch
there; the epoch order comes from numpy's `default_rng(seed)`, the
variational noise from an explicit `torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from ..device import resolve_device, set_f32_numerics
from ..models.embedding_net import EmbeddingNet


def embedding_train_step(net: EmbeddingNet, opt: torch.optim.Optimizer,
                         poses: torch.Tensor, variational: bool = False,
                         kld_weight: float = 0.1,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """One Adam update: Huber(recon, poses) (+ kld_weight KLD). Returns the
    loss, on the device."""
    eps = None
    if variational:
        eps = torch.randn((poses.shape[0], 32), generator=generator,
                          device=poses.device if generator is None else generator.device
                          ).to(poses.device)
    _, mu, log_var, recon = net.train()(poses, eps)
    loss = F.smooth_l1_loss(recon, poses, beta=1.0)
    if variational:
        kld = -0.5 * torch.mean(1 + log_var - mu ** 2 - torch.exp(log_var))
        loss = loss + kld_weight * kld
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def train_pose_embedding(pose_windows: np.ndarray, *, epochs: int = 20,
                         batch_size: int = 64, learning_rate: float = 5e-4,
                         variational: bool = False, seed: int = 0,
                         pose_dim: int = C.POSE_DIM, n_frames: int = C.N_POSES,
                         log_every: int = 0, device: str | torch.device | None = None,
                         log=print) -> dict:
    """Train the pose autoencoder on (N, T, pose_dim) windows, on `device`
    (the card unless `device="cpu"`). Returns {"state_dict": the weights
    on the CPU in the reference's names, "final_loss": the last
    minibatch's loss, "losses": each epoch's last minibatch loss}."""
    pose_windows = np.asarray(pose_windows, np.float32)
    n = len(pose_windows)
    if n < 2:
        raise ValueError("need at least 2 pose windows")
    batch_size = min(batch_size, n)
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_f32_numerics()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = EmbeddingNet(pose_dim=pose_dim, n_frames=n_frames)
    net = net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=learning_rate)
    generator = torch.Generator(device=dev).manual_seed(seed)

    data = torch.from_numpy(pose_windows).to(dev)            # staged once
    steps_per_epoch = max(1, n // batch_size)
    rng = np.random.default_rng(seed)
    losses = []
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(steps_per_epoch):
            loss = embedding_train_step(
                net, opt, data[order[s * batch_size:(s + 1) * batch_size]],
                variational, generator=generator)
        losses.append(float(loss))
        if log_every and (epoch + 1) % log_every == 0:
            log(f"[embedding] epoch {epoch + 1}/{epochs} recon loss {losses[-1]:.6f}")
    return {"state_dict": {k: v.cpu() for k, v in net.state_dict().items()},
            "final_loss": losses[-1] if losses else float("nan"), "losses": losses}
