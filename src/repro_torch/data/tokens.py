"""Synthetic LM token pipeline: seeded, host-sharded, restart-exact.

The JAX package's `data/tokens.py` with torch generators in place of
`jax.random` keys.  The stream is a pure function of (seed, step, shard),
so a restart at `start_step` reproduces the exact batch sequence.
Sequences are Markov chains, x_{t+1} = (a * x_t + 7 + n_t) % vocab, not
uniform noise, so a loss falling below the unigram entropy means
something.  A background thread keeps `depth` batches ready.

The chain is a pure function of its draws (`markov_tokens`): the
multiplier a, the start x0 and the noise n.  `synth_batch` draws them with
a `torch.Generator`; a test can feed `markov_tokens` the JAX package's own
draws instead.  The two generators give different numbers from one seed,
so the packages' streams are alike in distribution, not in values.
"""

from __future__ import annotations

import queue
import threading

import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.pointclouds import fold_in


def markov_tokens(a: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
                  vocab: int) -> dict:
    """{"tokens", "labels"} (B, S) int32 from a (B, 1), x0 (B, 1) and noise (B, S).

    tokens[:, t] = (a * x + 7 + noise[:, t]) % vocab with x the previous
    token (x0 before the first), in int64; labels are the tokens rolled
    left by one, the last label wrapping to the first token as the
    reference's `jnp.roll` does.
    """
    a64, x = a.to(torch.int64)[:, 0], x0.to(torch.int64)[:, 0]
    n64 = noise.to(torch.int64)
    steps = []
    for t in range(noise.shape[1]):
        x = (a64 * x + 7 + n64[:, t]) % vocab
        steps.append(x)
    tokens = torch.stack(steps, dim=1).to(torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def synth_batch(seed, batch: int, seq: int, vocab: int, *, device=None) -> dict:
    """One batch of Markov sequences: a in [1, 8), x0 in [0, vocab), noise in [0, 3).

    `seed` is an int (a generator on `device` is seeded with it) or a
    `torch.Generator` on `device`.  Drawn on `device`, the card by default.
    """
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
        device=dev).manual_seed(int(seed))
    kw = dict(generator=gen, device=dev)
    a = torch.randint(1, 8, (batch, 1), **kw)
    x0 = torch.randint(0, vocab, (batch, 1), **kw)
    noise = torch.randint(0, 3, (batch, seq), **kw)
    return markov_tokens(a, x0, noise, vocab)


def token_stream(seed: int, batch: int, seq: int, vocab: int, *, start_step: int = 0,
                 shard_id: int = 0, device=None):
    """Infinite stream of (step, batch): step s of shard k is drawn from
    fold_in(seed, s, k * 7919 + 13) alone, so resuming at `start_step`
    reproduces the stream exactly."""
    step = start_step
    while True:
        yield step, synth_batch(fold_in(seed, step, shard_id * 7919 + 13), batch, seq, vocab,
                                device=device)
        step += 1


class Prefetcher:
    """Background-thread prefetch with bounded depth (double buffering).

    The thread only draws: give it a stream of CPU tensors, and move each
    batch to the card on the consuming thread, so no worker thread touches
    a CUDA stream.  `close()` stops the thread (the stream is infinite);
    an exception in the stream is raised by `__next__`.
    """

    def __init__(self, iterator, depth: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="token-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue item unless closed; False once closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:  # noqa: BLE001 — handed to the consumer by __next__
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        """The next item (blocking); StopIteration at the end of the stream."""
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the thread and wait up to `timeout` seconds for it to end."""
        self._stop.set()
        self._thread.join(timeout)
