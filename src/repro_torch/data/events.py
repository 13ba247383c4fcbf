"""Synthetic event-stream tasks mirroring ElfCore's five benchmarks
(a numpy copy of ``repro.data.events``).

Spatiotemporal spike patterns with per-class templates, Poisson noise and
timing jitter; the channel count defaults to the chip's 512 inputs.

Also here: the functional stand-in for the async SerDes front-end —
``pack_events`` / ``unpack_events`` frame spike vectors into 30-bit-payload
serial packets, and ``DelayBuffer`` is the 4-slot spatiotemporal buffer that
emulates axonal delays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

TASK_NAMES = ("gesture", "nmnist", "shd_kws", "eeg_emotion", "nav_cue")


@dataclasses.dataclass
class EventTask:
    name: str
    n_classes: int
    n_in: int
    t_steps: int
    _template_fn: Callable[[int], np.ndarray]          # class -> [T, n_in] rates

    def __post_init__(self):
        self._templates = np.stack(
            [self._template_fn(c) for c in range(self.n_classes)])

    def sample(self, rng: np.random.Generator, batch: int,
               labels: np.ndarray | None = None) -> Tuple[np.ndarray, np.ndarray]:
        """-> (events [T, B, n_in] float {0,1}, labels [B] int32)."""
        if labels is None:
            labels = rng.integers(0, self.n_classes, size=(batch,))
        rates = self._templates[labels]                        # [B, T, n_in]
        jitter = rng.integers(-2, 3, size=(batch,))
        rates = np.stack([np.roll(r, j, axis=0) for r, j in zip(rates, jitter)])
        ev = (rng.random(rates.shape) < rates).astype(np.float32)
        return np.transpose(ev, (1, 0, 2)), labels.astype(np.int32)

    def sample_stream(self, rng: np.random.Generator, n_windows: int):
        """Yield ``n_windows`` back-to-back samples as a continuous stream:
        (events [T, n_in], label) per window — the serving-path view, where
        a "sample" is just a T-step window of an endless sensor stream."""
        for _ in range(n_windows):
            ev, lab = self.sample(rng, batch=1)
            yield ev[:, 0], int(lab[0])


def _grid(n_in: int) -> Tuple[int, int]:
    h = int(np.sqrt(n_in / 2))
    return h, n_in // h


def make_task(name: str, n_in: int = 512, t_steps: int = 50, seed: int = 0) -> EventTask:
    rng = np.random.default_rng([seed, hash(name) % (2 ** 31)])
    h, w = _grid(n_in)
    t = np.arange(t_steps)

    if name == "gesture":          # moving 2-D blob, direction per class
        n_classes = 10
        def tmpl(c):
            ang = 2 * np.pi * c / n_classes
            vx, vy = np.cos(ang), np.sin(ang)
            ys, xs = np.mgrid[0:h, 0:w]
            out = np.zeros((t_steps, h * w))
            for ti in t:
                cy = (h / 2 + vy * ti * h / t_steps) % h
                cx = (w / 2 + vx * ti * w / t_steps) % w
                d2 = (ys - cy) ** 2 + (xs - cx) ** 2
                out[ti] = (0.35 * np.exp(-d2 / 6.0)).reshape(-1)
            return _fit(out, n_in)
    elif name == "nmnist":         # static prototype + saccade shifts
        n_classes = 10
        protos = rng.random((n_classes, h * w)) ** 3 * 0.4
        def tmpl(c):
            out = np.zeros((t_steps, h * w))
            img = protos[c].reshape(h, w)
            for ti in t:
                sx, sy = int(2 * np.sin(ti / 5)), int(2 * np.cos(ti / 7))
                out[ti] = np.roll(np.roll(img, sx, 0), sy, 1).reshape(-1)
            return _fit(out, n_in)
    elif name == "shd_kws":        # spectro-temporal keyword sweeps
        n_classes = 10
        starts = rng.integers(0, n_in // 2, size=(n_classes,))
        slopes = rng.uniform(-4, 4, size=(n_classes,))
        def tmpl(c):
            out = np.zeros((t_steps, n_in))
            for ti in t:
                center = int(starts[c] + slopes[c] * ti) % n_in
                idx = (np.arange(-8, 9) + center) % n_in
                out[ti, idx] = 0.35 * np.exp(-np.arange(-8, 9) ** 2 / 12.0)
            return out
    elif name == "eeg_emotion":    # band-limited oscillation mixtures:
        # classes differ in band frequency AND scalp topography (like DEAP's
        # valence/arousal maps) — frequency alone is invisible to a
        # trace-integrating readout at these timescales.
        n_classes = 3
        freqs = [2.0, 5.0, 9.0]
        chan_phase = rng.uniform(0, 2 * np.pi, size=(n_in,))
        topo = rng.dirichlet(np.ones(3), size=n_in).T          # [3, n_in]
        def tmpl(c):
            osc = 0.5 * (1 + np.sin(2 * np.pi * freqs[c] * t[:, None] / t_steps
                                    + chan_phase[None, :]))
            return 0.45 * topo[c][None, :] * osc
    elif name == "nav_cue":        # delayed cue -> decision (temporal memory)
        n_classes = 2
        def tmpl(c):
            out = np.full((t_steps, n_in), 0.02)
            half = n_in // 2
            sl = slice(0, half) if c == 0 else slice(half, n_in)
            out[: t_steps // 5, sl] = 0.4          # cue
            out[-t_steps // 5:, :] = 0.1           # report period (both sides)
            return out
    else:
        raise ValueError(name)

    return EventTask(name, n_classes, n_in, t_steps, tmpl)


def _fit(x: np.ndarray, n_in: int) -> np.ndarray:
    if x.shape[1] == n_in:
        return x
    out = np.zeros((x.shape[0], n_in))
    out[:, : x.shape[1]] = x
    return out


# ---------------------------------------------------------------------------
# SerDes functional stand-in: the framing, not the circuits
# ---------------------------------------------------------------------------

PAYLOAD_BITS = 30


def pack_events(spikes: np.ndarray) -> np.ndarray:
    """[T, n_in] {0,1} -> serial packets [T, ceil(n_in/30)] uint32 (30-bit payload)."""
    t_steps, n_in = spikes.shape
    n_words = -(-n_in // PAYLOAD_BITS)
    padded = np.zeros((t_steps, n_words * PAYLOAD_BITS), np.uint32)
    padded[:, :n_in] = spikes.astype(np.uint32)
    words = padded.reshape(t_steps, n_words, PAYLOAD_BITS)
    weights = (1 << np.arange(PAYLOAD_BITS, dtype=np.uint64))
    return (words.astype(np.uint64) * weights).sum(-1).astype(np.uint32)


def unpack_events(packets: np.ndarray, n_in: int) -> np.ndarray:
    """Serial packets [T, n_words] uint32 -> [T, n_in] f32 spikes."""
    t_steps, n_words = packets.shape
    bits = (packets[..., None].astype(np.uint64)
            >> np.arange(PAYLOAD_BITS, dtype=np.uint64)) & 1
    return bits.reshape(t_steps, -1)[:, :n_in].astype(np.float32)


class DelayBuffer:
    """4-slot spatiotemporal buffer emulating axonal delays (Fig. 3)."""

    def __init__(self, n_in: int, depth: int = 4):
        self.buf = np.zeros((depth, n_in), np.float32)

    def push(self, spikes: np.ndarray, delay_taps=(0, 1, 2, 3),
             weights=(1.0, 0.5, 0.25, 0.125)) -> np.ndarray:
        self.buf = np.roll(self.buf, 1, axis=0)
        self.buf[0] = spikes
        return sum(w * self.buf[d] for d, w in zip(delay_taps, weights))
