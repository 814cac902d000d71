"""Weight bridge: the JAX package's model variables (the s2ag
PoseGenerator and its ablations, the TriModal generator, the
AffDiscriminator, the ConvDiscriminator, the DiscriminatorTriModal, the
EmbeddingNet in each mode and its PoseDecoderFC, the v1 pipeline's SER
net, generator and discriminator, and T2GNet) -> this port's state dicts.

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
    """layers.GRU params (w_ih_l{k}[_rev] (in, 3H), ...) -> nn.GRU keys;
    layers.LSTM's (the same names at 4H) -> nn.LSTM keys."""
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


def pose_generator_v1(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The v1 generator's flax variables -> reference state-dict keys: the
    TriModal's layout (JAX convert/jax_to_torch.py:280), its GRU's layer 0
    input wider by the emotion one-hot."""
    return pose_generator_trimodal(variables)


def aff_discriminator_v1(variables: Mapping[str, Any]) -> dict[str, Array]:
    """AffDiscriminatorV1's flax variables -> reference state-dict keys
    (JAX convert/jax_to_torch.py:310)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out: dict[str, Array] = {}
    for name in ("st_gcn1", "st_gcn2"):
        out.update(st_graph_conv(p[name], s[name], f"{name}."))
    for i in (1, 2):
        out.update(conv1d(p[f"conv{i}"], f"conv{i}"))
        out.update(batch_norm(p[f"bn{i}"], s[f"bn{i}"], f"batch_norm{i}"))
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out"], "out"))
    out.update(linear(p["out2"], "out2"))
    return out


def att_conv_rnn(variables: Mapping[str, Any]) -> dict[str, Array]:
    """AttConvRNN's (or AttConvRNNv2's, which has three convs and no LSTM)
    flax variables -> reference state-dict keys (JAX
    convert/jax_to_torch.py:325): the LSTM under `gru.`, the attention's
    two Dense layers as `attention.linear1` and `linear2`."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out: dict[str, Array] = {}
    for name in sorted(k for k in p if k.startswith("conv")):
        out.update(conv2d(p[name], name))
    out.update(linear(p["linear1"], "linear1"))
    out.update(batch_norm(p["bn_linear1"], s["bn_linear1"], "batch_norm_linear1"))
    if "lstm" in p:
        out.update(gru(p["lstm"], "gru."))
    out.update(linear(p["attention"]["Dense_0"], "attention.linear1"))
    out.update(linear(p["attention"]["Dense_1"], "attention.linear2"))
    out.update(linear(p["linear2"], "linear2"))
    out.update(linear(p["linear3"], "linear3"))
    return out


def _pose_encoder(enc: Mapping[str, Any], enc_s: Mapping[str, Any],
                  prefix: str) -> dict[str, Array]:
    out: dict[str, Array] = {}
    for i in range(3):   # conv_norm_relu blocks: net.{i}.0 conv, net.{i}.1 BN
        out.update(conv1d(enc[f"net{i}"]["conv"], f"{prefix}net.{i}.0"))
        out.update(batch_norm(enc[f"net{i}"]["bn"], enc_s[f"net{i}"]["bn"],
                              f"{prefix}net.{i}.1"))
    out.update(conv1d(enc["net3"], f"{prefix}net.3"))
    for name, i in (("out_net0", 0), ("out_net1", 3), ("out_net2", 6)):
        out.update(linear(enc[name], f"{prefix}out_net.{i}"))
    for name, i in (("out_bn0", 1), ("out_bn1", 4)):
        out.update(batch_norm(enc[name], enc_s[name], f"{prefix}out_net.{i}"))
    out.update(linear(enc["fc_mu"], f"{prefix}fc_mu"))
    out.update(linear(enc["fc_log_var"], f"{prefix}fc_log_var"))
    return out


def embedding_net_pose(variables: Mapping[str, Any]) -> dict[str, Array]:
    """The FGD EmbeddingNet(mode='pose')'s flax variables -> reference
    state-dict keys (the layout of outputs/embedding_net.pth.tar's
    `embedding_dict`)."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = _pose_encoder(p["pose_encoder"], s["pose_encoder"], "pose_encoder.")
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


def _pre_pose_net(p: Mapping[str, Any], s: Mapping[str, Any],
                  prefix: str) -> dict[str, Array]:
    out = linear(p["pre_net0"], f"{prefix}pre_pose_net.0")
    out.update(batch_norm(p["pre_bn"], s["pre_bn"], f"{prefix}pre_pose_net.1"))
    out.update(linear(p["pre_net1"], f"{prefix}pre_pose_net.3"))
    return out


def pose_decoder_fc(variables: Mapping[str, Any]) -> dict[str, Array]:
    """PoseDecoderFC's flax variables -> reference state-dict keys: the
    seed poses' net where it has one, `net` Linear/BN at 3i and 3i + 1, the
    last Linear at 12."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = _pre_pose_net(p, s, "") if "pre_net0" in p else {}
    for i in range(4):
        out.update(linear(p[f"net{i}"], f"net.{3 * i}"))
        out.update(batch_norm(p[f"bn{i}"], s[f"bn{i}"], f"net.{3 * i + 1}"))
    out.update(linear(p["net4"], "net.12"))
    return out


def context_encoder(variables: Mapping[str, Any]) -> dict[str, Array]:
    """ContextEncoder's flax variables -> reference state-dict keys: the
    text TCN, the WavEncoder, the GRU, `out` Linear/BN at 0, 1 and 3, the
    VAE heads."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = text_encoder_tcn(p["text_encoder"], "text_encoder.")
    out.update(wav_encoder(p["audio_encoder"], s["audio_encoder"], "audio_encoder."))
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out0"], "out.0"))
    out.update(batch_norm(p["out_bn"], s["out_bn"], "out.1"))
    out.update(linear(p["out1"], "out.3"))
    out.update(linear(p["fc_mu"], "fc_mu"))
    out.update(linear(p["fc_log_var"], "fc_log_var"))
    return out


def pose_decoder_gru(variables: Mapping[str, Any]) -> dict[str, Array]:
    """PoseDecoderGRU's flax variables -> reference state-dict keys: the seed
    poses' net, the GRU, `out` at 0 and 2."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = _pre_pose_net(p, s, "")
    out.update(gru(p["gru"], "gru."))
    out.update(linear(p["out0"], "out.0"))
    out.update(linear(p["out1"], "out.2"))
    return out


def embedding_net(variables: Mapping[str, Any]) -> dict[str, Array]:
    """EmbeddingNet(mode='speech' or 'random')'s flax variables ->
    reference state-dict keys: `context_encoder`, `pose_encoder` and the
    GRU `decoder`."""
    p, s = variables["params"], variables.get("batch_stats", {})
    out = _pose_encoder(p["pose_encoder"], s["pose_encoder"], "pose_encoder.")
    for name, mapper in (("context_encoder", context_encoder), ("decoder", pose_decoder_gru)):
        part = mapper({"params": p[name], "batch_stats": s[name]})
        out.update({f"{name}.{k}": v for k, v in part.items()})
    return out


def discriminator_trimodal(variables: Mapping[str, Any]) -> dict[str, Array]:
    """DiscriminatorTriModal's flax variables -> reference state-dict keys."""
    p = variables["params"]
    out = gru(p["gru"], "gru.")
    out.update(linear(p["out"], "out"))
    out.update(linear(p["out2"], "out2"))
    return out


def attention(p: Mapping[str, Any], prefix: str) -> dict[str, Array]:
    """flax MultiHeadDotProductAttention -> the port's four (d, d) linears:
    the q, k, v kernels (d, heads, head_dim) and biases (heads, head_dim),
    the output kernel (heads, head_dim, d), the head axes flattened."""
    out: dict[str, Array] = {}
    for name in ("query", "key", "value"):
        kernel = np.asarray(p[name]["kernel"])
        out[f"{prefix}{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        out[f"{prefix}{name}.bias"] = np.asarray(p[name]["bias"]).reshape(-1)
    kernel = np.asarray(p["out"]["kernel"])
    out[f"{prefix}out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    out[f"{prefix}out.bias"] = np.asarray(p["out"]["bias"])
    return out


def layer_norm(p: Mapping[str, Array], prefix: str) -> dict[str, Array]:
    return {f"{prefix}.weight": np.asarray(p["scale"]), f"{prefix}.bias": np.asarray(p["bias"])}


def t2g_net(variables: Mapping[str, Any]) -> dict[str, Array]:
    """T2GNet's flax variables -> the port's state dict: each encoder layer's
    self-attention, norms and feed-forward (`enc.{i}`), each decoder layer's
    with its cross-attention (`dec.{i}`), the two projections to the
    memory, the time-mixing convolutions, and the word table where it is a
    parameter (the GloVe table is the constructor's)."""
    p = variables["params"]
    out: dict[str, Array] = {}
    if "text_embedding" in p:
        out.update(embedding(p["text_embedding"], "text_embedding"))
    for kind, attn, norms in (("enc", ("self_attn",), 2),
                              ("dec", ("self_attn", "cross_attn"), 3)):
        i = 0
        while f"{kind}{i}" in p:
            layer, prefix = p[f"{kind}{i}"], f"{kind}.{i}."
            for k, name in enumerate(attn):
                out.update(attention(layer[f"MultiHeadDotProductAttention_{k}"],
                                     prefix + name + "."))
            for k in range(norms):
                out.update(layer_norm(layer[f"LayerNorm_{k}"], f"{prefix}norm{k + 1}"))
            out.update(linear(layer["Dense_0"], f"{prefix}linear1"))
            out.update(linear(layer["Dense_1"], f"{prefix}linear2"))
            i += 1
    out.update(linear(p["text_embed"], "text_embed"))
    out.update(linear(p["text_offsets_to_gestures"], "text_offsets_to_gestures"))
    for i in range(2):
        out.update(conv1d(p[f"smooth{i}"], f"smooth.{i}"))
    return out


def to_state_dict(arrays: Mapping[str, Array]) -> dict[str, torch.Tensor]:
    """numpy arrays -> contiguous, writable CPU tensors."""
    return {k: torch.from_numpy(np.array(v, copy=True, order="C"))
            for k, v in arrays.items()}


def load_jax(model: torch.nn.Module, mapper, variables: Mapping[str, Any]) -> None:
    """Load JAX variables into `model` through one of the mappers above
    (`pose_generator`, `pose_generator_trimodal`, `aff_discriminator`,
    `conv_discriminator_trimodal`, `discriminator_trimodal`,
    `embedding_net_pose`, `embedding_net`, `context_encoder`,
    `pose_decoder_gru`, `pose_decoder_fc`,
    `pose_generator_v1`, `aff_discriminator_v1`, `att_conv_rnn`, `t2g_net`),
    strict."""
    model.load_state_dict(to_state_dict(mapper(variables)), strict=True)


def strip_module_prefix(state: Mapping[str, Any]) -> dict[str, Any]:
    """Drop the `module.` prefix a DataParallel wrapper adds to every key."""
    return {k.removeprefix("module."): v for k, v in state.items()}


def reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference `.pth.tar`'s `gen_model_dict`, with the `module.` prefix
    its DataParallel wrapper added stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(blob["gen_model_dict"])
