"""Weight bridge: the JAX package's model variables (the s2ag
PoseGenerator and its ablations, the TriModal generator, the
AffDiscriminator, the ConvDiscriminator, the FGD EmbeddingNet) -> this
port's state dicts.

The JAX variables are a nested dict of numpy arrays (`params` plus
`batch_stats`, what `jax.device_get` returns for a flax variable tree). The
mappers below are pure layout transforms, the same as the JAX package's
`convert/jax_to_torch.py` inverse mappers, and emit the reference's torch
state-dict keys, which are this port's parameter names. So
`load_state_dict(strict=True)` takes the result, and also takes a reference
`.pth.tar`'s `gen_model_dict` once its `module.` prefix is stripped.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

Array = np.ndarray


def linear(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """kernel (in, out) -> weight (out, in)."""
    out = {f"{prefix}.weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def conv1d(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """(K, Cin, Cout) -> (Cout, Cin, K)."""
    out = {f"{prefix}.weight": np.transpose(np.asarray(p["kernel"]), (2, 1, 0))}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def conv_transpose1d(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """(K, Cin, Cout), the forward-conv orientation the JAX layer stores ->
    torch ConvTranspose1d's (Cin, Cout, K)."""
    out = {f"{prefix}.weight": np.transpose(np.asarray(p["kernel"]), (1, 2, 0))}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def conv2d(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """(kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)."""
    out = {f"{prefix}.weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))}
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
    return out


def wn_conv1d(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """v (K, Cin, Cout) -> weight_v (Cout, Cin, K); g (Cout,) -> weight_g
    (Cout, 1, 1)."""
    return {
        f"{prefix}.weight_v": np.transpose(np.asarray(p["v"]), (2, 1, 0)),
        f"{prefix}.weight_g": np.asarray(p["g"]).reshape(-1, 1, 1),
        f"{prefix}.bias": np.asarray(p["bias"]),
    }


def batch_norm(params: Mapping[str, Array], stats: Mapping[str, Array],
               prefix: str) -> dict[str, Array]:
    """num_batches_tracked, which the JAX side does not carry, is 0."""
    return {
        f"{prefix}.weight": np.asarray(params["scale"]),
        f"{prefix}.bias": np.asarray(params["bias"]),
        f"{prefix}.running_mean": np.asarray(stats["mean"]),
        f"{prefix}.running_var": np.asarray(stats["var"]),
        f"{prefix}.num_batches_tracked": np.asarray(0, dtype=np.int64),
    }


def gru(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    """layers.GRU params (w_ih_l{k}[_rev] (in, 3H), ...) -> nn.GRU keys."""
    num_layers = 1 + max(int(k.split("_l")[-1].removesuffix("_rev"))
                         for k in p if k.startswith("w_ih_l"))
    dirs = ["", "_reverse"] if "w_ih_l0_rev" in p else [""]
    out: dict[str, Array] = {}
    for layer in range(num_layers):
        for d, suffix in enumerate(dirs):
            tag = f"l{layer}" + ("_rev" if d else "")
            out[f"{prefix}weight_ih_l{layer}{suffix}"] = np.asarray(p[f"w_ih_{tag}"]).T
            out[f"{prefix}weight_hh_l{layer}{suffix}"] = np.asarray(p[f"w_hh_{tag}"]).T
            out[f"{prefix}bias_ih_l{layer}{suffix}"] = np.asarray(p[f"b_ih_{tag}"])
            out[f"{prefix}bias_hh_l{layer}{suffix}"] = np.asarray(p[f"b_hh_{tag}"])
    return out


def embedding(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    return {f"{prefix}.weight": np.asarray(p["embedding"])}


def temporal_conv_net(p: Mapping[str, Any], prefix: str) -> dict[str, Array]:
    """Each TemporalBlock's convs appear twice, as `conv1`/`conv2` and as
    `net.0`/`net.4` (the reference registers them both ways)."""
    out: dict[str, Array] = {}
    net_idx = {1: 0, 2: 4}
    for name, block in p.items():
        i = int(name.removeprefix("block"))
        for j in (1, 2):
            conv = wn_conv1d(block[f"conv{j}"]["WNConv1d_0"],
                             f"{prefix}network.{i}.conv{j}")
            out.update(conv)
            out.update({k.replace(f".conv{j}.", f".net.{net_idx[j]}."): v
                        for k, v in conv.items()})
        if "downsample" in block:
            out.update(conv1d(block["downsample"], f"{prefix}network.{i}.downsample"))
    return out


def text_encoder_tcn(p: Mapping[str, Any], prefix: str) -> dict[str, Array]:
    out = embedding(p["embedding"], f"{prefix}embedding")
    out.update(temporal_conv_net(p["tcn"], f"{prefix}tcn."))
    out.update(linear(p["decoder"], f"{prefix}decoder"))
    return out


def st_graph_conv(p: Mapping[str, Any], s: Mapping[str, Any],
                  prefix: str) -> dict[str, Array]:
    out = conv2d(p["gcn"]["conv"], f"{prefix}gcn.conv")
    out.update(batch_norm(p["tcn_bn1"], s["tcn_bn1"], f"{prefix}tcn.0"))
    out.update(conv2d(p["tcn_conv"], f"{prefix}tcn.2"))
    out.update(batch_norm(p["tcn_bn2"], s["tcn_bn2"], f"{prefix}tcn.3"))
    out.update(conv2d(p["res_conv"], f"{prefix}residual.0"))
    out.update(batch_norm(p["res_bn"], s["res_bn"], f"{prefix}residual.1"))
    return out


def aff_encoder(p: Mapping[str, Any], s: Mapping[str, Any],
                prefix: str) -> dict[str, Array]:
    out: dict[str, Array] = {}
    for name in ("st_gcn1", "st_gcn2"):
        out.update(st_graph_conv(p[name], s[name], f"{prefix}{name}."))
    for name, ref in (("batch_norm1", "batch_norm1"), ("batch_norm2", "batch_norm2"),
                      ("bn3", "batch_norm3"), ("bn4", "batch_norm4")):
        out.update(batch_norm(p[name], s[name], f"{prefix}{ref}"))
    out.update(conv1d(p["conv3"], f"{prefix}conv3"))
    out.update(conv1d(p["conv4"], f"{prefix}conv4"))
    return out


def mfcc_encoder(p: Mapping[str, Any], s: Mapping[str, Any],
                 prefix: str) -> dict[str, Array]:
    out = linear(p["linear1"], f"{prefix}linear1")
    for i in range(1, 5):
        out.update(conv1d(p[f"conv{i}"], f"{prefix}conv{i}"))
        out.update(batch_norm(p[f"bn{i}"], s[f"bn{i}"], f"{prefix}batch_norm{i}"))
    return out


def wav_encoder(p: Mapping[str, Any], s: Mapping[str, Any],
                prefix: str) -> dict[str, Array]:
    """The reference's `feat_extractor` Sequential: convs at 0, 3, 6, 9 and
    batch norms at 1, 4, 7."""
    out: dict[str, Array] = {}
    for name, i in (("conv1", 0), ("conv2", 3), ("conv3", 6), ("conv4", 9)):
        out.update(conv1d(p[name], f"{prefix}feat_extractor.{i}"))
    for name, i in (("bn1", 1), ("bn2", 4), ("bn3", 7)):
        out.update(batch_norm(p[name], s[name], f"{prefix}feat_extractor.{i}"))
    return out


def speaker_z(p: Mapping[str, Any]) -> dict[str, Array]:
    out = embedding(p["embedding"], "speaker_embedding.0")
    out.update(linear(p["proj"], "speaker_embedding.1"))
    out.update(linear(p["mu"], "speaker_mu"))
    out.update(linear(p["log_var"], "speaker_log_var"))
    return out


def _audio_encoder(p: Mapping[str, Any], s: Mapping[str, Any]) -> dict[str, Array]:
    """The audio encoder a generator's variables hold, if any: the
    MFCCEncoder (its `linear1`) or the WavEncoder."""
    if "audio_encoder" not in p:
        return {}
    enc = mfcc_encoder if "linear1" in p["audio_encoder"] else wav_encoder
    return enc(p["audio_encoder"], s["audio_encoder"], "audio_encoder.")


def _generator_tail(p: Mapping[str, Any]) -> dict[str, Array]:
    """The text encoder and the speaker z where the variables hold them,
    the GRU and the head."""
    out: dict[str, Array] = {}
    if "text_encoder" in p:
        out.update(text_encoder_tcn(p["text_encoder"], "text_encoder."))
    if "speaker_z" in p:
        out.update(speaker_z(p["speaker_z"]))
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out1"], "out.0"))
    out.update(linear(p["out2"], "out.2"))
    return out


def pose_generator(variables: Mapping[str, Any]) -> dict[str, Array]:
    """A PoseGenerator's flax variables -> reference state-dict keys, for
    every variant and setting: the AffEncoder (not abl_aff's), the MFCC or
    (abl_audio) the WavEncoder, the text encoder and the speaker z where
    the variables hold them."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out: dict[str, Array] = {}
    if "aff_encoder" in p:
        out.update(aff_encoder(p["aff_encoder"], s["aff_encoder"], "aff_encoder."))
    out.update(_audio_encoder(p, s))
    out.update(_generator_tail(p))
    return out


def pose_generator_trimodal(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The TriModal generator's flax variables -> reference state-dict keys
    (its WavEncoder, text encoder and speaker z where the variables hold
    them)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = _audio_encoder(p, s)
    out.update(_generator_tail(p))
    return out


def aff_discriminator(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The AffDiscriminator's flax variables -> reference state-dict keys."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = aff_encoder(p["aff_encoder"], s["aff_encoder"], "aff_encoder.")
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out"], "out"))
    out.update(linear(p["out2"], "out2"))
    return out


def conv_discriminator_trimodal(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The ConvDiscriminatorTriModal's (and abl_aff's ConvDiscriminator's)
    flax variables -> reference state-dict keys: `pre_conv` convs at 0, 3,
    6, batch norms at 1, 4 (the JAX package's convert/torch_ckpt.py
    :307-323 reads the same names)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out: dict[str, Array] = {}
    for name, i in (("pre_conv1", 0), ("pre_conv2", 3), ("pre_conv3", 6)):
        out.update(conv1d(p[name], f"pre_conv.{i}"))
    for name, i in (("pre_bn1", 1), ("pre_bn2", 4)):
        out.update(batch_norm(p[name], s[name], f"pre_conv.{i}"))
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out"], "out"))
    out.update(linear(p["out2"], "out2"))
    return out


def embedding_net_pose(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The FGD EmbeddingNet(mode='pose')'s flax variables -> reference
    state-dict keys (the layout of outputs/embedding_net.pth.tar's
    `embedding_dict`)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    enc, enc_s = p["pose_encoder"], s["pose_encoder"]
    out: dict[str, Array] = {}
    for i in range(3):   # conv_norm_relu blocks: net.{i}.0 conv, net.{i}.1 BN
        out.update(conv1d(enc[f"net{i}"]["conv"], f"pose_encoder.net.{i}.0"))
        out.update(batch_norm(enc[f"net{i}"]["bn"], enc_s[f"net{i}"]["bn"],
                              f"pose_encoder.net.{i}.1"))
    out.update(conv1d(enc["net3"], "pose_encoder.net.3"))
    for name, i in (("out_net0", 0), ("out_net1", 3), ("out_net2", 6)):
        out.update(linear(enc[name], f"pose_encoder.out_net.{i}"))
    for name, i in (("out_bn0", 1), ("out_bn1", 4)):
        out.update(batch_norm(enc[name], enc_s[name], f"pose_encoder.out_net.{i}"))
    out.update(linear(enc["fc_mu"], "pose_encoder.fc_mu"))
    out.update(linear(enc["fc_log_var"], "pose_encoder.fc_log_var"))
    dec, dec_s = p["decoder"], s["decoder"]
    out.update(linear(dec["pre0"], "decoder.pre_net.0"))
    out.update(batch_norm(dec["pre_bn0"], dec_s["pre_bn0"], "decoder.pre_net.1"))
    out.update(linear(dec["pre1"], "decoder.pre_net.3"))
    for name, i in (("net0", 0), ("net1", 3)):
        out.update(conv_transpose1d(dec[name], f"decoder.net.{i}"))
    for name, i in (("bn0", 1), ("bn1", 4)):
        out.update(batch_norm(dec[name], dec_s[name], f"decoder.net.{i}"))
    out.update(conv1d(dec["net2"], "decoder.net.6"))
    out.update(conv1d(dec["net3"], "decoder.net.7"))
    return out


def to_state_dict(arrays: Mapping[str, Array]) -> dict[str, torch.Tensor]:
    """numpy arrays -> contiguous, writable CPU tensors."""
    return {k: torch.from_numpy(np.array(v, copy=True, order="C"))
            for k, v in arrays.items()}


def load_jax(model: torch.nn.Module, mapper, variables: Mapping[str, Any]) -> None:
    """Load JAX variables into `model` through one of the mappers above
    (`pose_generator`, `pose_generator_trimodal`, `aff_discriminator`,
    `conv_discriminator_trimodal`, `embedding_net_pose`), strict."""
    model.load_state_dict(to_state_dict(mapper(variables)), strict=True)


def strip_module_prefix(state: Mapping[str, Any]) -> dict[str, Any]:
    """Drop the `module.` prefix a DataParallel wrapper adds to every key."""
    return {k.removeprefix("module."): v for k, v in state.items()}


def reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference `.pth.tar`'s `gen_model_dict`, with the `module.` prefix
    its DataParallel wrapper added stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(blob["gen_model_dict"])
