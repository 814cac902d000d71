"""Embedding-space evaluation: the Fréchet Gesture Distance (FGD) and the
test-split metrics (reference `net/embedding_space_evaluator.py` and
`Processor.push_samples`, processor_v2.py:732-774, as the JAX package's
`train/evaluator.py` rebuilt them).

- A frozen `EmbeddingNet(mode="pose")` embeds real and generated 34-frame
  sequences to 32-d on the evaluator's device, in eval mode with full
  float32 products (TF32 off on the card). FGD is the Fréchet distance
  between Gaussian fits of the two feature sets, computed on the host in
  float64 with scipy's `sqrtm`, with the reference's branches for a
  non-finite root and a complex one; feat_dist is the mean per-pair L1.
- `push_sample_metrics`: the L1 of the direction vectors, the joint MAE
  after forward kinematics, and the acceleration difference.
- The plots of the embedding space: `get_features_for_viz` projects the
  features to 2-D with UMAP where it is installed, else with a PCA of
  this module's own (`pca_2d`, sklearn's `PCA(n_components=2)` and its
  sign convention, in numpy); `draw_embedding_space` scatters them with
  matplotlib, imported when it runs.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch
from scipy import linalg

from .. import constants as C
from ..convert.from_jax import strip_module_prefix
from ..device import resolve_device, set_f32_numerics
from ..models.embedding_net import EmbeddingNet
from ..ops import pose as pose_ops
from .losses import AverageMeter


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's matrix square root without its error estimate: the
    reference's `sqrtm(m, disp=False)[0]` where scipy still has the flag
    (newer scipy removed it and returns the root alone)."""
    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(m, disp=False)[0]
    return linalg.sqrtm(m)


def pca_2d(x: np.ndarray) -> np.ndarray:
    """The rows of x projected on their first two principal axes, as
    sklearn's `PCA(n_components=2).fit_transform` gives them: the data
    centered, the axes the right singular vectors, each axis's sign set so
    that its component of largest magnitude is positive (sklearn's
    `svd_flip(u_based_decision=False)`). Computed in float64, returned in
    x's floating dtype."""
    x = np.asarray(x)
    centered = x.astype(np.float64) - x.mean(axis=0, dtype=np.float64)
    vt = np.linalg.svd(centered, full_matrices=False)[2][:2]
    vt *= np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(axis=1)])[:, None]
    out = centered @ vt.T
    return out.astype(x.dtype) if np.issubdtype(x.dtype, np.floating) else out


class EmbeddingSpaceEvaluator:
    """FGD scorer around a frozen gesture autoencoder, on `device` (the
    card unless `device="cpu"`)."""

    def __init__(self, net: EmbeddingNet, device: str | torch.device | None = None,
                 n_pre_poses: int = C.N_PRE_POSES):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.n_pre_poses = n_pre_poses
        self.reset()

    @classmethod
    def from_torch_checkpoint(cls, path: str, device: str | torch.device | None = None,
                              pose_dim: int = C.POSE_DIM, n_frames: int = C.N_POSES,
                              **kw) -> "EmbeddingSpaceEvaluator":
        """The reference's frozen outputs/embedding_net.pth.tar (key
        'embedding_dict', DataParallel's `module.` prefix stripped;
        net/embedding_space_evaluator.py:20-27), or one that
        `train_embedding` wrote, loaded strict."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        net = EmbeddingNet(pose_dim=pose_dim, n_frames=n_frames)
        net.load_state_dict(strip_module_prefix(blob["embedding_dict"]), strict=True)
        return cls(net, device, **kw)

    @classmethod
    def random_init(cls, seed: int = 0, device: str | torch.device | None = None,
                    **kw) -> "EmbeddingSpaceEvaluator":
        """A freshly initialized embedding net (tests and smoke runs: the
        scores are well defined, not comparable to the paper's)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = EmbeddingNet()
        return cls(net, device, **kw)

    @torch.no_grad()
    def _embed(self, poses) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(poses, dtype=torch.float32).to(self.device)
        feat, _, _, recon = self.net(x)
        return x, feat, recon

    def reset(self):
        self.real_feat_list: list[np.ndarray] = []
        self.generated_feat_list: list[np.ndarray] = []
        self.recon_err_diff: list[float] = []

    def get_no_of_samples(self) -> int:
        return sum(len(f) for f in self.real_feat_list)

    def push_samples(self, generated_poses, real_poses):
        """Embed a batch of generated and real direction-vector sequences
        (B, T, 27), numpy arrays or tensors on any device."""
        real, real_feat, real_recon = self._embed(real_poses)
        gen, gen_feat, gen_recon = self._embed(generated_poses)
        self.real_feat_list.append(real_feat.cpu().numpy())
        self.generated_feat_list.append(gen_feat.cpu().numpy())
        err_real = float((real - real_recon).abs().mean())
        err_fake = float((gen - gen_recon).abs().mean())
        self.recon_err_diff.append(err_fake - err_real)

    def get_scores(self) -> tuple[float, float]:
        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        frechet_dist = self.frechet_distance(generated, real)
        feat_dist = float(np.mean(np.sum(np.abs(real - generated), axis=1)))
        return frechet_dist, feat_dist

    def get_features_for_viz(self) -> tuple[np.ndarray, np.ndarray]:
        """2-D projections of the (real, generated) features (ref
        net/embedding_space_evaluator.py:63-72): UMAP where it is installed
        (the reference's), else `pca_2d`."""
        generated = np.vstack(self.generated_feat_list)
        real = np.vstack(self.real_feat_list)
        both = np.vstack((generated, real))
        try:
            import umap
        except ImportError:
            transformed = pca_2d(both)
        else:
            transformed = umap.UMAP().fit_transform(both)
        n = transformed.shape[0] // 2
        return transformed[n:], transformed[:n]

    def draw_embedding_space(self, output_path: str) -> str:
        """A scatter plot of the 2-D embedding space, real against
        generated, written to `output_path`; needs matplotlib."""
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("draw_embedding_space needs matplotlib, which is not "
                              "installed") from e
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        real2d, gen2d = self.get_features_for_viz()
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(real2d[:, 0], real2d[:, 1], s=6, alpha=0.5, label="real")
        ax.scatter(gen2d[:, 0], gen2d[:, 1], s=6, alpha=0.5, label="generated")
        ax.legend()
        ax.set_title("gesture embedding space")
        fig.savefig(output_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return output_path

    @staticmethod
    def frechet_distance(samples_a: np.ndarray, samples_b: np.ndarray) -> float:
        mu_a, mu_b = samples_a.mean(0), samples_b.mean(0)
        cov_a = np.cov(samples_a, rowvar=False)
        cov_b = np.cov(samples_b, rowvar=False)
        try:
            return EmbeddingSpaceEvaluator.calculate_frechet_distance(
                mu_a, cov_a, mu_b, cov_b)
        except ValueError:
            return 1e10

    @staticmethod
    def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
        """The stable Fréchet distance of two Gaussians (ref
        net/embedding_space_evaluator.py:103-156)."""
        diff = mu1 - mu2
        cov_mean = _sqrtm(sigma1.dot(sigma2))
        if not np.isfinite(cov_mean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            cov_mean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
        if np.iscomplexobj(cov_mean):
            if not np.allclose(np.diagonal(cov_mean).imag, 0, atol=1e-3):
                raise ValueError(f"Imaginary component {np.max(np.abs(cov_mean.imag))}")
            cov_mean = cov_mean.real
        return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                     - 2 * np.trace(cov_mean))


def push_sample_metrics(target_dir_vec, out_dir_vec, mean_dir_vec: np.ndarray,
                        losses_all: AverageMeter, joint_mae: AverageMeter,
                        accel: AverageMeter, n_pre_poses: int = C.N_PRE_POSES,
                        evaluator: EmbeddingSpaceEvaluator | None = None):
    """L1, joint MAE after forward kinematics and the acceleration
    difference of one batch (ref Processor.push_samples, processor_v2.py
    :737-774). The direction vectors (B, T, 27) are numpy arrays or
    tensors; the metrics are computed where `out_dir_vec` lies."""
    out = torch.as_tensor(out_dir_vec, dtype=torch.float32)
    target = torch.as_tensor(target_dir_vec, dtype=torch.float32).to(out.device)
    batch_size = len(target)
    losses_all.update(float((out - target).abs().mean()), batch_size)
    if evaluator is not None:
        evaluator.push_samples(out, target)

    mean = torch.as_tensor(np.asarray(mean_dir_vec, np.float32).reshape(-1)).to(out.device)
    out_poses = pose_ops.convert_dir_vec_to_pose(out + mean)
    target_poses = pose_ops.convert_dir_vec_to_pose(target + mean)
    diff = out_poses[:, n_pre_poses:] - target_poses[:, n_pre_poses:]
    joint_mae.update(float(diff.abs().mean()), batch_size)
    target_acc = torch.diff(target_poses, n=2, dim=1)
    out_acc = torch.diff(out_poses, n=2, dim=1)
    accel.update(float((target_acc - out_acc).abs().mean()), batch_size)
    return losses_all, joint_mae, accel
