"""MPI Emotional Body Expressions + GloVe loader, the T2GNet corpus (the
port of the JAX package's `data/mpi_glove.py`, numpy as there).

The reference's `loader_v2.load_data_with_glove` (loader_v2.py:707-819)
calls `MocapDataset.get_mpi_affective_features`, which does not exist
anywhere in the reference tree; the JAX package rebuilt the same contract,
and this module copies it:

    load_data_with_glove(path, 'mpi', glove_path)
        -> (data_dict, word2idx, embedding_table, tag_categories,
            max_time_steps)

- `tag_names.txt` gives the row of each tag in a clip's tag file; the 10
  relevant tags, one-hot over each tag's own categories (the order of
  first appearance over the sorted tag files), Age / 100, the text split
  into alphanumeric tokens;
- the BVH clips are read through the port's `render/bvh.load_bvh`, every
  `frame_drop`-th frame from the second on;
- `mpi_affective_features` stands in for the missing reference call, with
  the JAX package's descriptors (distances, angles and areas among the
  extremities, head and root; speeds and accelerations);
- `build_vocab_idx` and `build_embedding_table` follow loader_v2.py
  :642-705 (PAD 0, UNK 1, BOS 2, EOS 3; words absent from the GloVe file
  drawn from N(0, 0.6), from a seeded generator);
- the result is cached in `data_dict_glove_drop_{frame_drop}.npz` under
  the JAX package's name and layout, so each package reads the other's.

The MPI archive and a GloVe file are not in the repo: the tests and
`chip_smoke.py` write synthetic ones in this layout.
"""

from __future__ import annotations

import glob as _glob
import os
from os.path import join as j

import numpy as np

from ..render import bvh as bvh_io

# transformer special tokens (ref utils/constant.py)
PAD, UNK, BOS, EOS = 0, 1, 2, 3
PAD_WORD, UNK_WORD, BOS_WORD, EOS_WORD = "<BLANK>", "<UNK>", "<SOS>", "<EOS>"

RELEVANT_TAGS = [
    "Intended emotion", "Intended polarity", "Perceived category",
    "Perceived polarity", "Acting task", "Gender", "Age", "Handedness",
    "Native tongue", "Text",
]


def to_one_hot(value: str, categories: list[str]) -> np.ndarray:
    """loader_v2.py:121-125."""
    out = np.zeros(len(categories))
    out[categories.index(value)] = 1.0
    return out


def build_vocab_idx(word_instants, min_word_count: int = 0) -> dict:
    """Word -> index over all sentences (loader_v2.py:642-672): special
    tokens first, then every word whose count exceeds min_word_count.
    Content-word index order is deterministic first-seen here; the
    reference iterates a set (loader_v2.py:652), so its indices change
    with PYTHONHASHSEED between runs."""
    word2idx = {BOS_WORD: BOS, EOS_WORD: EOS, PAD_WORD: PAD, UNK_WORD: UNK}
    word_count: dict[str, int] = {}
    for sent in word_instants:
        for w in sent:
            word_count[w] = word_count.get(w, 0) + 1
    for word, count in word_count.items():
        if word not in word2idx and count > min_word_count:
            word2idx[word] = len(word2idx)
    return word2idx


def build_embedding_table(embedding_path: str, target_vocab: dict,
                          seed: int = 0) -> np.ndarray:
    """GloVe text file -> (n_vocab, dim) table (loader_v2.py:675-705):
    words absent from the file (incl. the special tokens) get a random
    N(0, 0.6) row like the reference — but from a SEEDED generator so the
    table is reproducible (the reference draws from global numpy state)."""
    vectors = {}
    dim = None
    with open(embedding_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            vectors[parts[0]] = np.asarray(parts[1:], dtype=np.float64)
            dim = len(parts) - 1
    if dim is None:
        raise ValueError(f"no vectors in {embedding_path}")
    rng = np.random.default_rng(seed)
    table = np.zeros((len(target_vocab), dim))
    for word, idx in target_vocab.items():
        if word in vectors:
            table[idx] = vectors[word]
        else:
            table[idx] = rng.normal(scale=0.6, size=(dim,))
    return table


# joint-name keys used to pick the descriptor joints; falls back to root
# when a name is absent so the features are defined on any skeleton
_FEATURE_JOINTS = ("head", "neck", "spine", "lefthand", "righthand",
                   "leftfoot", "rightfoot", "hips")


def _find_joint(names: list[str], key: str) -> int:
    for i, n in enumerate(names):
        if key in n.lower().replace("_", ""):
            return i
    return 0


def mpi_affective_features(positions: np.ndarray, names: list[str]
                           ) -> np.ndarray:
    """Per-frame affective posture descriptors from world positions
    (T, J, 3) -> (T, F).

    Replaces the reference's nonexistent
    `MocapDataset.get_mpi_affective_features` (the call at
    loader_v2.py:782 that makes the upstream loader dead code) with the
    descriptor family its paper lineage uses: distances and angles among
    extremities/head/root, triangle areas (body openness), and
    velocity/acceleration magnitudes of the extremities.
    """
    idx = {k: _find_joint(names, k) for k in _FEATURE_JOINTS}
    p = np.asarray(positions, np.float64)
    root = p[:, idx["hips"]]
    scale = np.maximum(
        np.linalg.norm(p[:, idx["head"]] - root, axis=-1, keepdims=True),
        1e-6,
    )

    def dist(a, b):
        return (np.linalg.norm(p[:, idx[a]] - p[:, idx[b]], axis=-1,
                               keepdims=True) / scale)

    def angle(a, b, c):
        """Angle at b in the a-b-c chain."""
        u = p[:, idx[a]] - p[:, idx[b]]
        v = p[:, idx[c]] - p[:, idx[b]]
        cosang = np.sum(u * v, axis=-1) / np.maximum(
            np.linalg.norm(u, axis=-1) * np.linalg.norm(v, axis=-1), 1e-9
        )
        return np.arccos(np.clip(cosang, -1.0, 1.0))[:, None]

    def area(a, b, c):
        u = p[:, idx[a]] - p[:, idx[b]]
        v = p[:, idx[c]] - p[:, idx[b]]
        return (0.5 * np.linalg.norm(np.cross(u, v), axis=-1, keepdims=True)
                / scale[:, 0:1] ** 2)

    feats = [
        dist("lefthand", "righthand"),          # hand openness
        dist("lefthand", "head"), dist("righthand", "head"),
        dist("leftfoot", "rightfoot"),          # stride width
        dist("head", "hips"),                   # uprightness (≈1 by scale)
        angle("lefthand", "neck", "righthand"),  # shoulder spread
        angle("head", "neck", "spine"),          # head drop
        area("lefthand", "neck", "righthand"),   # upper-body triangle
        area("leftfoot", "hips", "rightfoot"),   # lower-body triangle
    ]
    for joint in ("lefthand", "righthand", "head"):
        vel = np.gradient(p[:, idx[joint]], axis=0)
        acc = np.gradient(vel, axis=0)
        feats.append(np.linalg.norm(vel, axis=-1, keepdims=True) / scale)
        feats.append(np.linalg.norm(acc, axis=-1, keepdims=True) / scale)
    return np.concatenate(feats, axis=-1).astype(np.float32)


def _read_tag_file(path: str) -> list[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f.readlines()]


def load_data_with_glove(_path: str, dataset: str, embedding_src: str,
                         frame_drop: int = 1, add_mirrored: bool = False):
    """Working equivalent of loader_v2.load_data_with_glove (:707-819)
    for dataset='mpi'; same npz cache contract and return tuple.

    add_mirrored is accepted for signature parity but ignored — the
    reference declares it (loader_v2.py:707) and never reads it in the
    body either; we warn instead of silently dropping the request."""
    if add_mirrored:
        import warnings

        warnings.warn(
            "add_mirrored=True is a no-op: the reference's "
            "load_data_with_glove declares but never implements it "
            "(loader_v2.py:707); no mirrored copies are added",
            stacklevel=2,
        )
    data_path = j(_path, dataset)
    cache = j(data_path, f"data_dict_glove_drop_{frame_drop}.npz")
    if os.path.exists(cache):
        blob = np.load(cache, allow_pickle=True)
        return (blob["data_dict"].item(), blob["word2idx"].item(),
                blob["embedding_table"], list(blob["tag_categories"]),
                blob["max_time_steps"].item())
    if dataset != "mpi":
        raise FileNotFoundError(f"dataset {dataset!r} not supported")

    tag_names = _read_tag_file(j(data_path, "tag_names.txt"))
    id_row = tag_names.index("ID")
    tag_files = sorted(_glob.glob(j(data_path, "tags/*.txt")))
    if not tag_files:
        raise FileNotFoundError(f"no tag files under {data_path}/tags")

    # first pass: category vocabularies over all files (loader_v2.py:739-750)
    tag_categories: list[list[str]] = [[] for _ in RELEVANT_TAGS[:-1]]
    for tag_file in tag_files:
        tag_data = _read_tag_file(tag_file)
        for c, tag in enumerate(RELEVANT_TAGS[:-1]):
            value = tag_data[tag_names.index(tag)]
            if value not in tag_categories[c]:
                tag_categories[c].append(value)

    data_dict: dict[str, dict] = {}
    all_texts = []
    max_time_steps = 0
    for tag_file in tag_files:
        tag_data = _read_tag_file(tag_file)
        clip_id = tag_data[id_row]
        names, parents, offsets, positions, rotations, _fps = bvh_io.load_bvh(
            j(data_path, "bvh", clip_id + ".bvh")
        )
        positions = positions[1::frame_drop]
        rotations = rotations[1::frame_drop]
        max_time_steps = max(max_time_steps, len(positions))
        lower = [n.lower() for n in names]
        entry: dict = {
            "joints_dict": {
                "joints_to_model": np.arange(len(parents)),
                "joints_parents_all": parents,
                "joints_parents": parents,
                "joints_names_all": names,
                "joints_names": names,
                "joints_offsets_all": offsets,
                "joints_left": [i for i, n in enumerate(lower) if "left" in n],
                "joints_right": [i for i, n in enumerate(lower) if "right" in n],
            },
            "positions": positions,
            "rotations": rotations,
            "affective_features": mpi_affective_features(positions, names),
        }
        for c, tag in enumerate(RELEVANT_TAGS):
            value = tag_data[tag_names.index(tag)]
            if tag == "Text":
                all_texts.append([w for w in value.split() if w.isalnum()])
                entry[tag] = value
            elif tag == "Age":
                entry[tag] = float(value) / 100.0
            else:
                # DOCUMENTED DIVERGENCE (loader_v2.py:795-801): the
                # reference compares `tag_name is 'Perceived category'`;
                # CPython dedups equal string constants per code object,
                # so the `is` tests are TRUE and the reference encodes
                # the two Perceived tags against tag_categories[0]/[1] —
                # the INTENDED emotion/polarity vocabularies — crashing
                # on any perceived label absent from the intended list.
                # The straightforward per-tag category list is used here.
                entry[tag] = to_one_hot(value, tag_categories[c])
        data_dict[clip_id] = entry

    word2idx = build_vocab_idx(all_texts, min_word_count=0)
    embedding_table = build_embedding_table(embedding_src, word2idx)
    np.savez_compressed(
        cache, data_dict=data_dict, word2idx=word2idx,
        embedding_table=embedding_table,
        tag_categories=np.asarray(tag_categories, dtype=object),
        max_time_steps=max_time_steps,
    )
    return data_dict, word2idx, embedding_table, tag_categories, max_time_steps
