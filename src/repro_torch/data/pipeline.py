"""Data pipeline (``repro/data/pipeline.py``, copied: numpy only, the same
batches bit for bit): deterministic, shardable, checkpointable.

Two sources behind one iterator interface:

  * ``SyntheticLM`` — deterministic PRNG token stream (zipf-ish unigram mix
    with short-range structure so the loss actually falls) — used by the
    train launcher and ``chip_smoke.py``'s train phase;
  * ``MemmapCorpus`` — pre-tokenized .npy shard files read via memmap with a
    shuffle buffer — the "real file" path (a generator utility is included).

Both are sharded by (host_index, host_count) — each host reads a disjoint
stream — and expose ``state()`` / ``restore()`` so the exact batch sequence
resumes after preemption (state rides inside the checkpoint; see
train/checkpoint.py).  Batches are int32 numpy arrays; the caller moves
them to the device."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["SyntheticLM", "MemmapCorpus", "write_corpus"]


@dataclasses.dataclass
class _State:
    step: int
    epoch: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure:
    tok[t] = (a * tok[t-1] + noise) % vocab on a zipf-ish base."""

    def __init__(self, vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        assert batch % host_count == 0, "global batch must split across hosts"
        self.vocab = vocab
        self.batch = batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host = host_index
        self._state = _State(step=0)

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 9_973 + self.host * 7) % (2**31))
        base = rng.zipf(1.3, size=(self.batch, self.seq + 1)) % self.vocab
        # short-range determinism: half the tokens are affine in the previous
        mask = rng.rand(self.batch, self.seq) < 0.5
        nxt = (base[:, :-1] * 31 + 17) % self.vocab
        tokens = base[:, 1:].copy()
        tokens[mask] = nxt[mask]
        full = np.concatenate([base[:, :1], tokens], axis=1)
        return {
            "tokens": full[:, :-1].astype(np.int32),
            "labels": full[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._make(self._state.step)
        self._state.step += 1
        return b

    def state(self) -> dict:
        return dataclasses.asdict(self._state)

    def restore(self, s: dict) -> None:
        self._state = _State(**s)


def write_corpus(path: str, vocab: int, n_tokens: int, *, seed: int = 0,
                 shard_tokens: int = 1 << 20) -> List[str]:
    """Generate a tokenized corpus as .npy shards (the 'real data' path)."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    files = []
    written = 0
    i = 0
    while written < n_tokens:
        n = min(shard_tokens, n_tokens - written)
        arr = (rng.zipf(1.3, size=n) % vocab).astype(np.int32)
        f = os.path.join(path, f"shard_{i:05d}.npy")
        np.save(f, arr)
        files.append(f)
        written += n
        i += 1
    return files


class MemmapCorpus:
    """Sharded memmap reader with a deterministic shuffle over windows."""

    def __init__(self, path: str, batch: int, seq_len: int, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npy shards under {path}")
        self.maps = [np.load(f, mmap_mode="r") for f in self.files]
        self.total = sum(m.shape[0] for m in self.maps)
        self.offsets = np.cumsum([0] + [m.shape[0] for m in self.maps])
        assert batch % host_count == 0
        self.batch = batch // host_count
        self.seq = seq_len
        self.seed = seed
        self.host = host_index
        self.host_count = host_count
        self.n_windows = self.total // (seq_len + 1)
        self._state = _State(step=0, epoch=0)

    def _window(self, w: int) -> np.ndarray:
        start = w * (self.seq + 1)
        fi = int(np.searchsorted(self.offsets, start, side="right") - 1)
        local = start - self.offsets[fi]
        out = []
        need = self.seq + 1
        while need:
            chunk = self.maps[fi][local : local + need]
            out.append(np.asarray(chunk))
            need -= len(chunk)
            fi, local = fi + 1, 0
        return np.concatenate(out)

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + self._state.epoch)
        perm = rng.permutation(self.n_windows)
        per_step = self.batch * self.host_count
        base = self._state.step * per_step + self.host * self.batch
        if base + self.batch > self.n_windows:
            self._state = _State(step=0, epoch=self._state.epoch + 1)
            return next(self)
        rows = np.stack([self._window(int(perm[base + i]))
                         for i in range(self.batch)])
        self._state.step += 1
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self):
        return self

    def state(self) -> dict:
        return dataclasses.asdict(self._state)

    def restore(self, s: dict) -> None:
        self._state = _State(**s)
