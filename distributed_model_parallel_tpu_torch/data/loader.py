"""Host-side batch order + on-device augmentation and normalization — the
port of ``distributed_model_parallel_tpu/data/loader.py``.

The host shuffles indices (numpy, the same stateless ``(seed, epoch)``
permutation as the JAX package, so batch order is bit-identical) and
hands over uint8 NHWC batches; random crop, flip and normalization run on
the device. Augmentation is split in two: :func:`draw_crop_flip` draws
the crop offsets and flips from a ``torch.Generator`` (the port's own
bits, not JAX's), and :func:`apply_crop_flip` applies given draws — the
part the tests hold bit for bit against the JAX ``augment_batch`` fed
its own draws.

Data parallelism: every rank draws the same global batch order and
materializes its own rows (``BatchLoader(rows=...)``); a rank's
augmentation draws come from ``(seed, step, rank)`` (DDP, each replica its
own draws) or are the global batch's draws, of which it takes its rows
(the gspmd strategy, one program over the global batch).

Not ported yet (ROADMAP A3): the C++ row gather (``use_native``),
the host and device prefetch stages and the on-device resize of the
224 px path.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.data.registry import ArrayDataset


class BatchLoader:
    """Epoch-shuffled uint8 batch iterator over an ArrayDataset.

    Shuffle order is stateless: epoch ``e``'s permutation comes from
    ``default_rng((seed, e))``, so the loader's position is two integers
    (``state_dict``: epoch + batch cursor). Iteration never moves the
    cursor except at clean exhaustion (next epoch); the epoch drivers call
    :meth:`set_epoch` at the top of each epoch, as in the JAX package.
    ``rows``: the slice of each global batch this rank materializes (all
    of it by default).
    """

    def __init__(self, ds: ArrayDataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 use_native: bool = False, rows: slice = slice(None)):
        if batch_size > len(ds):
            raise ValueError(
                f"batch size {batch_size} exceeds dataset size {len(ds)}")
        if use_native:
            raise ValueError("use_native (the C++ row gather) is not ported "
                             "yet (ROADMAP A3)")
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rows = rows
        self._epoch = 0
        self._cursor = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def cursor(self) -> int:
        return self._cursor

    def set_epoch(self, epoch: int) -> None:
        """Position at the start of ``epoch`` unless already inside it."""
        if epoch != self._epoch:
            self._epoch, self._cursor = int(epoch), 0

    def state_dict(self) -> dict:
        """Resume state; a fully consumed epoch reads as the start of the
        next."""
        ep, cur = self._epoch, self._cursor
        if cur >= len(self):
            ep, cur = ep + 1, 0
        return {"epoch": int(ep), "batch_cursor": int(cur)}

    def load_state_dict(self, state: Mapping) -> None:
        ep, cur = int(state["epoch"]), int(state["batch_cursor"])
        if ep < 0 or cur < 0 or cur > len(self):
            raise ValueError(
                f"invalid loader state epoch={ep} batch_cursor={cur} "
                f"(epoch has {len(self)} batches)")
        if cur >= len(self):
            ep, cur = ep + 1, 0
        self._epoch, self._cursor = ep, cur

    def epoch_indices(self, epoch: int | None = None) -> np.ndarray:
        """The sample order of ``epoch`` (default: the current one),
        derived from ``(seed, epoch)`` only."""
        n = len(self.ds)
        if not self.shuffle:
            return np.arange(n)
        e = self._epoch if epoch is None else int(epoch)
        return np.random.default_rng((self.seed, e)).permutation(n)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        n = len(self.ds)
        epoch, start = self._epoch, self._cursor
        idx = self.epoch_indices(epoch)
        stop = ((n // self.batch_size) * self.batch_size if self.drop_last
                else n)
        for lo in range(start * self.batch_size, stop, self.batch_size):
            sel = idx[lo:lo + self.batch_size][self.rows]
            yield self.ds.images[sel], self.ds.labels[sel]
        if epoch == self._epoch and start == self._cursor:
            self._epoch, self._cursor = epoch + 1, 0


def resolve_input_size(images_shape, image_size: int
                       ) -> tuple[int | None, int]:
    """(resize_to, input_hw): ``resize_to`` is None when ``image_size`` is
    the dataset's native resolution."""
    native_h, native_w = images_shape[1:3]
    if native_h != native_w:
        raise ValueError(
            f"the resize/input path assumes square images; dataset is "
            f"{native_h}x{native_w} — pre-crop it square")
    resize_to = image_size if image_size != native_h else None
    return resize_to, (resize_to or native_h)


def normalize(images_u8: torch.Tensor, mean, std,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized ``dtype``, each operation rounded in
    ``dtype`` as the JAX ``normalize`` does. ``mean``/``std`` may be numpy
    arrays or (to keep host copies out of a step loop) tensors already in
    ``dtype`` on the images' device."""
    x = images_u8.to(dtype) / 255.0
    mean = torch.as_tensor(mean, dtype=dtype, device=x.device)
    std = torch.as_tensor(std, dtype=dtype, device=x.device)
    return (x - mean) / std


def step_generator(seed: int, step: int, device,
                   rank: int | None = None) -> torch.Generator:
    """The augmentation generator of global step ``step`` (of ``rank``,
    when each rank draws its own): stateless, derived from ``(seed,
    step[, rank])`` only (host arithmetic, no device sync)."""
    entropy = [int(seed), int(step)] + ([] if rank is None else [int(rank)])
    state = np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def draw_crop_flip(generator: torch.Generator, batch: int, *, pad: int = 4,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop offsets ``[B, 2]`` in ``[0, 2·pad]`` and flips ``[B]`` (bool,
    p = 0.5), drawn on ``device`` from ``generator``."""
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=generator,
                            device=device)
    flips = torch.rand(batch, generator=generator, device=device) < 0.5
    return offsets, flips


def apply_crop_flip(images_u8: torch.Tensor, offsets: torch.Tensor,
                    flips: torch.Tensor | None, *,
                    pad: int = 4) -> torch.Tensor:
    """Random crop (pad-and-crop) + horizontal flip with given draws:
    zero-pad ``pad`` on each side, gather rows then columns at the
    offsets, mirror the rows whose flip is set. uint8 NHWC in and out."""
    b, h, w, c = images_u8.shape
    padded = F.pad(images_u8, (0, 0, pad, pad, pad, pad))
    offsets = offsets.to(images_u8.device, torch.long)
    rows = offsets[:, 0, None] + torch.arange(h, device=images_u8.device)
    out = torch.gather(padded, 1, rows[:, :, None, None].expand(
        b, h, w + 2 * pad, c))
    cols = offsets[:, 1, None] + torch.arange(w, device=images_u8.device)
    out = torch.gather(out, 2, cols[:, None, :, None].expand(b, h, w, c))
    if flips is not None:
        out = torch.where(flips.to(images_u8.device)[:, None, None, None],
                          out.flip(2), out)
    return out


def augment_batch(generator: torch.Generator, images_u8: torch.Tensor, *,
                  pad: int = 4, flip: bool = True,
                  rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Random crop + horizontal flip on the device: the reference's
    ``RandomCrop(32, padding=4)`` + ``RandomHorizontalFlip``. ``rows =
    (start, total)``: ``images_u8`` are rows ``start ..`` of a batch of
    ``total``, and take those rows of the whole batch's draws."""
    b = images_u8.shape[0]
    start, total = rows if rows is not None else (0, b)
    offsets, flips = draw_crop_flip(generator, total, pad=pad,
                                    device=images_u8.device)
    offsets, flips = offsets[start:start + b], flips[start:start + b]
    return apply_crop_flip(images_u8, offsets, flips if flip else None,
                           pad=pad)
