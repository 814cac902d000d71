"""The streaming loader (`--loader grain`): the batches of the JAX package's
grain pipeline (`data/grain_loader.py`: an `IndexSampler` with shuffle, no
sharding and no last epoch, seed `max(seed, 0)`; each row decoded by
`decode_rows`; `Batch(B, drop_remainder=True)`; each batch's adversarial
speakers drawn with the batch's own rng), made here without `grain`.

The stream, as grain 0.2.15 makes it in process (`worker_count=0`):
- global record g is the row `index_shuffle(g % n, n - 1, (seed + g // n)
  % 2**32)`: one permutation an epoch, each with its own seed;
- batch t holds records t B ... t B + B - 1, so a batch runs across an
  epoch boundary when n % B != 0;
- batch t's speakers are `sample_adversarial_speakers(pool, own, rng, B)`
  with rng = `np.random.Generator(np.random.Philox(key=seed + t B + B -
  1))`: the rng of the batch's last record.

`index_shuffle` is grain's C++ `grain::random::index_shuffle`, a Simon
cipher on the smallest even W >= 16 bits with 2**W >= max_index, walked
until it lands in [0, max_index]. Grain's quirk, kept for parity: when
n - 1 is exactly 2**W (n = 65537, 262145, ...) the cipher never yields
n - 1, so each epoch drops one row and repeats another.

The loader's state is the index of the next batch and the seed; the
trainer keeps both in its checkpoint's data-state file, so that a run
resumes in the middle of an epoch. The split stays on the host. A
batch's rows are gathered there as packed, into pinned memory when the
device is a card, and copied without blocking; the device decodes them
with `decode_rows`'s float64 arithmetic, so the bits are those of the
host decode that the JAX package runs per row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .ted_db import PackedDataset, sample_adversarial_speakers, speaker_id_pool

_M32 = 0xFFFFFFFF


def seed_seq_words(seed: int, n: int) -> list[int]:
    """The n 32-bit words of C++ `std::seed_seq{seed}.generate(...)`
    ([rand.util.seedseq], one input word: seed mod 2**32)."""
    v = [seed & _M32]
    s = len(v)
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        r2 = (r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """The positions `index` (an int or an array in [0, max_index]) of a
    permutation of [0, max_index] keyed by `seed`, as grain's C++
    `index_shuffle`: a Simon cipher of `rounds` rounds on W bits, its round
    keys `seed_seq_words(seed, rounds)` masked to W / 2 bits, cycle-walked
    until the result is <= max_index."""
    w = 16
    while (1 << w) < max_index:
        w += 2
    h = w // 2
    mask = np.uint64((1 << h) - 1)
    keys = [np.uint64(k) & mask for k in seed_seq_words(seed, rounds)]
    one, two, eight, hh = (np.uint64(r) for r in (1, 2, 8, h))
    top = np.uint64(max_index)

    def rotl(x, r):
        return ((x << r) | (x >> (hh - r))) & mask

    def encrypt(x):
        lo, hi = x & mask, (x >> hh) & mask
        for k in keys:
            f = (rotl(lo, one) & rotl(lo, eight)) ^ rotl(lo, two)
            lo, hi = hi ^ f ^ k, lo
        return (hi << hh) | lo

    x = np.array(index, dtype=np.uint64)
    if w > 16:
        # 2**W < 4 max_index: the walks are short
        todo = np.ones(x.shape, bool)
        while todo.any():
            x[todo] = encrypt(x[todo])
            todo = x > top
        return x.astype(np.int64)
    # W 16 at a small max_index: a walk may take thousands of steps, so the
    # cipher's table over the whole domain, and each value's stop found by
    # doubling the jumps (the input's bits past W dropped, as the cipher's
    # halves drop them)
    domain = np.arange(1 << 16, dtype=np.uint64)
    step = encrypt(domain)
    stop = np.where(domain <= top, domain, step)
    start = step[x & np.uint64(0xFFFF)]
    while (stop[start] > top).any():
        stop = stop[stop]
    return stop[start].astype(np.int64)


@functools.lru_cache(maxsize=2)
def epoch_permutation(n: int, seed: int) -> np.ndarray:
    """The rows of one epoch of n records in the stream's order under the
    epoch's seed, made once and kept for the epoch's batches (the last two
    epochs', for a batch across a boundary): a batch then costs the loader
    a slice, not a cipher walk of its own."""
    perm = index_shuffle(np.arange(n), n - 1, seed)
    perm.flags.writeable = False
    return perm


def batch_rows(n: int, batch_size: int, seed: int, t: int) -> np.ndarray:
    """The rows of batch t: records t B ... t B + B - 1 of the stream, each
    epoch's part through its own permutation."""
    g = np.arange(t * batch_size, (t + 1) * batch_size, dtype=np.int64)
    epoch, pos = np.divmod(g, n)
    rows = np.empty_like(g)
    for e in np.unique(epoch):
        sel = epoch == e
        rows[sel] = epoch_permutation(n, (seed + int(e)) % 2 ** 32)[pos[sel]]
    return rows


def decode(raw: dict) -> dict:
    """A batch of packed rows (`GrainLoader.packed_batch`'s) in the
    training dtypes, where its tensors lie, with `decode_rows`'s
    arithmetic and so its bits: int64 words, float32 poses, the int16 audio
    times its float64 maximum divided by 32767 in float64 (by a tensor:
    PyTorch's CUDA division by a host scalar multiplies by its reciprocal)
    and rounded to float32, the float16 MFCC widened."""
    audio, amax = raw["audio"], raw["audio_max"].double()
    scale = torch.tensor(32767.0, dtype=torch.float64, device=audio.device)
    return {
        "extended_word_seq": raw["extended_word_seq"].long(),
        "vec_seq": raw["vec_seq"].float(),
        "audio": (audio.double() * amax[:, None] / scale).float(),
        "mfcc_features": raw["mfcc_features"].float(),
        "vid_indices": raw["vid_indices"],
    }


class GrainLoader:
    """An endless iterator over the batches of `dataset` in the stream's
    order, from batch `next_batch` on, each on `device`: batch t is
    `packed_batch(t)` (the rows as packed, and the adversarial speakers),
    pinned for a card, copied without blocking and `decode`d on the
    device, which equals `decode_rows` on the host bit for bit at a
    fraction of the host's time and of the bytes copied (int16 audio,
    float16 MFCC). The host's part (a few ms) runs in the step: made one
    batch ahead on a worker thread it gave no steady gain on the H100
    (`chip_smoke.py` `grain_numbers` times both), since the launching
    thread, which takes and drops the interpreter lock at every operation,
    slows beside another thread that takes it. `next_batch` counts the
    batches handed out. `part` picks the rows of each batch that this
    loader hands out: a data-parallel rank's (`DataMesh.rows`), every rank
    running the same global stream, with the speakers drawn over the whole
    batch (JAX's trainer splits its grain batches so, trainer.py:237-239,
    :274-277); all of them by default."""

    # the packed arrays a batch copies, in their dtypes in the split
    FIELDS = ("extended_word_seq", "vec_seq", "audio", "audio_max", "mfcc_features")

    def __init__(self, dataset: PackedDataset, batch_size: int, seed: int,
                 device: str | torch.device = "cpu", part: slice = slice(None)):
        self.ds, self.batch_size, self.part = dataset, batch_size, part
        self.device = torch.device(device)
        pool = speaker_id_pool(dataset)
        self.speakers = np.arange(1) if pool is None else pool
        self.seed, self.next_batch = seed, 0

    def state(self) -> dict:
        return {"next_batch": self.next_batch, "seed": self.seed}

    def set_state(self, state: dict) -> None:
        self.next_batch, self.seed = int(state["next_batch"]), int(state["seed"])

    def packed_batch(self, t: int, seed: int, pin: bool = False) -> dict:
        """Batch t of the stream of `seed` as CPU tensors (in pinned memory
        with `pin`), `part` of its rows: those rows of the packed split in
        the split's dtypes, each field copied by one `np.take`, and their
        adversarial speakers (int64, `vid_indices`) of the whole batch's
        draw."""
        ds, bs = self.ds, self.batch_size
        rows = batch_rows(ds.n_samples, bs, seed, t)
        mine = rows[self.part]
        out = {}
        for k in self.FIELDS:
            src = getattr(ds, k)
            # np.take fills the tensor's numpy view, of the source's dtype
            out[k] = torch.empty((len(mine), *src.shape[1:]),
                                 dtype=torch.from_numpy(src[:0]).dtype, pin_memory=pin)
            np.take(src, mine, axis=0, out=out[k].numpy(), mode="clip")
        rng = np.random.Generator(np.random.Philox(key=seed + (t + 1) * bs - 1))
        out["vid_indices"] = torch.from_numpy(sample_adversarial_speakers(
            self.speakers, ds.vid_indices[rows], rng, bs).astype(np.int64)[self.part])
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        raw = self.packed_batch(self.next_batch, self.seed, pin=self.device.type == "cuda")
        self.next_batch += 1
        return decode({k: v.to(self.device, non_blocking=True) for k, v in raw.items()})
