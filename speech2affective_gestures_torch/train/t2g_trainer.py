"""T2GNet training and synthesis: text + affect tags -> gesture quaternion
sequences (the JAX package's `train/t2g_trainer.py`).

The reference defines T2GNet (net/T2GNet.py, net/T2GNet_glove.py) but no
processor trains it, and its loader is dead (see `data/mpi_glove.py`). The
JAX package closed the loop, and this module ports it:

- `prepare_t2g_arrays` turns an `mpi_glove` corpus into fixed-shape arrays
  (text padded to the longest sentence, quaternions padded with identity
  frames to max_time_steps and masked out of the loss, the bone lengths,
  each tag's one-hot and Age as one column);
- `t2g_train_step` is one teacher-forced Adam update under the
  reference's quaternion objective `losses.quat_angle_loss` (the decoder's
  input is the target shifted right behind an identity frame; padded
  frames are replaced by their targets, so they add nothing);
- `train_t2g` runs the epochs in the JAX loop's batch order (each epoch's
  permutation from `np.random.default_rng(seed)`);
- `generate_quat_sequence` decodes greedily over an identity-filled buffer
  of max_time_steps frames, the whole model once per frame, as the JAX
  package's `lax.fori_loop` does.

Adam is optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square
root), which `torch.optim.Adam` computes. The entry points run on the card
unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import mpi_glove
from ..device import resolve_device
from ..models import layers as L
from ..models.t2g import T2GNet, init_flax_like, t2g_net_glove
from . import losses

IDENTITY_QUAT = np.array([1.0, 0.0, 0.0, 0.0], np.float32)


def tokenize(text: str, word2idx: dict) -> list[int]:
    """Alphanumeric tokens (the filter `mpi_glove` builds the vocabulary
    with) -> BOS ids EOS, UNK for a word outside the vocabulary."""
    words = [w for w in text.split() if w.isalnum()]
    return ([mpi_glove.BOS] + [word2idx.get(w, mpi_glove.UNK) for w in words]
            + [mpi_glove.EOS])


def prepare_t2g_arrays(data_dict: dict, word2idx: dict, tag_categories: list,
                       max_time_steps: int) -> dict:
    """An `mpi_glove` data_dict -> {text (B, S) int32, tags [(B, d) float32
    per tag, Age (B, 1)], quat (B, T, J*4) float32, frame_mask (B, T),
    offset_lengths (B, J), clip_ids, n_joints}. Clips sorted by id, every one
    on one skeleton."""
    clip_ids = sorted(data_dict)
    first = data_dict[clip_ids[0]]
    n_joints = len(first["joints_dict"]["joints_parents"])
    tok = [tokenize(data_dict[c]["Text"], word2idx) for c in clip_ids]
    s_max = max(len(t) for t in tok)
    b, t_max = len(clip_ids), int(max_time_steps)

    text = np.full((b, s_max), mpi_glove.PAD, np.int32)
    quat = np.tile(IDENTITY_QUAT, (b, t_max, n_joints, 1)).astype(np.float32)
    mask = np.zeros((b, t_max), np.float32)
    offsets = np.zeros((b, n_joints), np.float32)
    # one category list per tag but Text, Age's too: the loader stores Age
    # as value / 100, so its feature is one column
    tag_names = [t for t in mpi_glove.RELEVANT_TAGS if t != "Text"]
    tags = [np.zeros((b, 1 if name == "Age" else len(cats)), np.float32)
            for name, cats in zip(tag_names, tag_categories)]

    for i, cid in enumerate(clip_ids):
        entry = data_dict[cid]
        text[i, : len(tok[i])] = tok[i]
        rot = np.asarray(entry["rotations"], np.float32)[:t_max]
        if rot.shape[1] != n_joints:
            raise ValueError(f"clip {cid} has {rot.shape[1]} joints, expected {n_joints}")
        quat[i, : len(rot)] = rot
        mask[i, : len(rot)] = 1.0
        offsets[i] = np.linalg.norm(
            np.asarray(entry["joints_dict"]["joints_offsets_all"],
                       np.float32).reshape(n_joints, -1)[:, :3], axis=-1)
        for k, name in enumerate(tag_names):
            tags[k][i] = entry[name] if name != "Age" else [entry[name]]

    return {"text": text, "tags": tags, "quat": quat.reshape(b, t_max, n_joints * 4),
            "frame_mask": mask, "offset_lengths": offsets, "clip_ids": clip_ids,
            "n_joints": n_joints}


def build_t2g_net(embedding_table: np.ndarray, arrays: dict, device=None, seed: int = 0,
                  **overrides) -> T2GNet:
    """T2GNet_glove configured from the prepared arrays (the frozen GloVe
    table; the quaternion and offset widths from the skeleton, the tag
    widths from the corpus; dropout 0.1), its parameters drawn from `seed`
    by flax's initializers, on `device` (the card unless "cpu")."""
    kwargs = dict(quat_dim=arrays["quat"].shape[-1],
                  offsets_dim=arrays["offset_lengths"].shape[-1],
                  tag_dims=tuple(t.shape[-1] for t in arrays["tags"]), dropout=0.1)
    kwargs.update(overrides)
    net = t2g_net_glove(embedding_table, int(arrays["quat"].shape[1]), **kwargs)
    init_flax_like(net, torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def to_device(arrays: dict, device: torch.device) -> dict:
    """The arrays a step and the decode read, as tensors on `device`."""
    return {"text": torch.from_numpy(arrays["text"]).to(device, torch.long),
            "tags": [torch.from_numpy(t).to(device) for t in arrays["tags"]],
            "quat": torch.from_numpy(arrays["quat"]).to(device),
            "frame_mask": torch.from_numpy(arrays["frame_mask"]).to(device),
            "offset_lengths": torch.from_numpy(arrays["offset_lengths"]).to(device)}


def select(batch: dict, rows: torch.Tensor) -> dict:
    """The rows `rows` of every array of `to_device`'s dict."""
    return {k: [t[rows] for t in v] if k == "tags" else v[rows] for k, v in batch.items()}


def start_frame(n_joints: int, like: torch.Tensor) -> torch.Tensor:
    """The identity quaternion of every joint, (n_joints * 4,)."""
    return torch.from_numpy(np.tile(IDENTITY_QUAT, n_joints)).to(like)


def t2g_loss(net: T2GNet, batch: dict, n_joints: int):
    """(angle + drift, angle, drift) of one teacher-forced pass in the
    net's mode: the decoder reads the target shifted right behind an
    identity frame; padded frames are replaced by their targets;
    `quat_angle_loss` with every joint upper body and drift_len min(20, T)."""
    quat = batch["quat"]
    start = start_frame(n_joints, quat).expand(quat.shape[0], 1, -1)
    teacher = torch.cat([start, quat[:, :-1]], dim=1)
    pred, _ = net(batch["text"], batch["tags"], teacher, batch["offset_lengths"])
    m = batch["frame_mask"][..., None]
    pred = pred * m + quat * (1.0 - m)
    angle, drift = losses.quat_angle_loss(pred, quat, num_joints=n_joints,
                                          lower_body_start=n_joints,
                                          drift_len=min(20, pred.shape[1]))
    return angle + drift, angle, drift


def t2g_train_step(net: T2GNet, optimizer: torch.optim.Optimizer, batch: dict,
                   n_joints: int, generator: torch.Generator | None = None) -> dict:
    """One teacher-forced Adam update in train mode, the dropout masks drawn
    from `generator`; returns the loss, angle and drift (detached)."""
    net.train()
    with L.dropout_rng(generator):
        loss, angle, drift = t2g_loss(net, batch, n_joints)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "angle": angle.detach(), "drift": drift.detach()}


def make_optimizer(net: T2GNet, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate)'s defaults over the net's parameters."""
    return torch.optim.Adam(net.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def train_t2g(data_dict: dict, word2idx: dict, embedding_table: np.ndarray,
              tag_categories: list, max_time_steps: int, *, epochs: int = 50,
              batch_size: int = 8, learning_rate: float = 1e-3, seed: int = 0,
              net_overrides: dict | None = None, device=None) -> dict:
    """Train T2GNet_glove on an mpi_glove corpus: parameters from `seed`,
    dropout masks from a generator seeded with `seed` on the device, each
    epoch's batches in the JAX loop's order. Returns {'net', 'optimizer',
    'arrays', 'history' (each epoch's mean loss), 'final_loss'}."""
    dev = resolve_device(device)
    arrays = prepare_t2g_arrays(data_dict, word2idx, tag_categories, max_time_steps)
    net = build_t2g_net(embedding_table, arrays, dev, seed, **(net_overrides or {}))
    optimizer = make_optimizer(net, learning_rate)
    generator = torch.Generator(device=dev).manual_seed(seed)
    data = to_device(arrays, dev)
    n = len(arrays["clip_ids"])
    history = []
    rng = np.random.default_rng(seed)    # each epoch's order: the JAX loop's
    for _ in range(epochs):
        rows = torch.from_numpy(rng.permutation(n)).to(dev)
        epoch_loss, n_batches = 0.0, 0
        for s in range(0, n, batch_size):
            metrics = t2g_train_step(net, optimizer, select(data, rows[s: s + batch_size]),
                                     arrays["n_joints"], generator)
            epoch_loss += float(metrics["loss"])
            n_batches += 1
        history.append(epoch_loss / max(1, n_batches))
    return {"net": net, "optimizer": optimizer, "arrays": arrays, "history": history,
            "final_loss": history[-1] if history else None}


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """An array or tensor as a tensor of `dtype` on `device`."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device, dtype)


@torch.no_grad()
def generate_quat_sequence(net: T2GNet, text, tags, offset_lengths,
                           n_frames: int | None = None, device=None) -> np.ndarray:
    """Greedy autoregressive decode in eval mode: the decoder's input is a
    buffer of max_time_steps identity frames; step t runs the whole model on
    it, keeps its frame t and writes that frame into slot min(t + 1, T - 1).
    Returns the kept frames (B, n_frames, J*4), unit quaternions. The net
    moves to `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    net.to(dev).eval()
    t_max = net.max_time_steps
    n_frames = t_max if n_frames is None else min(int(n_frames), t_max)
    text = _on(text, dev, torch.long)
    tags = [_on(t, dev, torch.float32) for t in tags]
    offset_lengths = _on(offset_lengths, dev, torch.float32)
    b, d = text.shape[0], net.quat_dim
    buf = start_frame(d // 4, offset_lengths).expand(b, t_max, d).clone()
    out = torch.zeros(b, t_max, d, device=dev)
    for t in range(n_frames):
        pred, _ = net(text, tags, buf, offset_lengths)
        out[:, t] = pred[:, t]
        buf[:, min(t + 1, t_max - 1)] = pred[:, t]
    return out[:, :n_frames].cpu().numpy()
