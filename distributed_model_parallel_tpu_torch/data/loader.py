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
materializes its own rows (``BatchLoader(rows=spec.rows(batch))``, or
``shard_by_process``: the same rows, from the mesh this process joined);
a rank's augmentation draws come from ``(seed, step,
rank)`` (DDP, each replica its own draws) or are the global batch's
draws, of which it takes its rows (the gspmd strategy, one program over
the global batch).

The host path: ``use_native`` assembles each batch with the C++ row
gather (``data/native.py``); :class:`PrefetchLoader` assembles the next
``prefetch`` batches on a host thread and :class:`DevicePrefetchLoader`
uploads the next ``device_prefetch`` batches on a side CUDA stream while
the current step runs. Neither moves the loader's position: the trainers
own it (:meth:`BatchLoader.position`). :func:`resize_batch` is the
on-device bilinear resize of the 224 px input path.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.data.registry import ArrayDataset


class BatchLoader:
    """Epoch-shuffled uint8 batch iterator over an ArrayDataset.

    Shuffle order is stateless: epoch ``e``'s permutation comes from
    ``default_rng((seed, e))``, so the loader's position is two integers
    (``state_dict``: epoch + batch cursor). Iteration never moves the
    cursor except at clean exhaustion (next epoch): a prefetch stage
    produces ahead of what the trainer consumed, so the epoch drivers call
    :meth:`set_epoch` at the top of each epoch and :meth:`position` with
    what they consumed, as in the JAX package. ``rows``: the slice of each
    global batch this rank materializes (all of it by default);
    ``shard_by_process``: this process's data row's contiguous share of
    it, by its place on the data axis of the mesh it joined
    (:func:`~..mesh.process_rows`; without a process group, the whole
    batch).
    ``use_native``: the C++ row gather over ``num_workers`` threads (a
    lazily decoded dataset's indexing is its decode, so it is used
    as-is).
    """

    def __init__(self, ds: ArrayDataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 use_native: bool = False, num_workers: int = 4,
                 shard_by_process: bool = False, rows: slice = slice(None)):
        if batch_size > len(ds):
            raise ValueError(
                f"batch size {batch_size} exceeds dataset size {len(ds)}")
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.use_native = use_native
        self.num_workers = num_workers
        self.seed = seed
        self._epoch = 0
        self._cursor = 0
        if shard_by_process:
            if rows != slice(None):
                raise ValueError("pass rows or shard_by_process, not both")
            from distributed_model_parallel_tpu_torch.mesh import (
                process_rows,
            )

            rows = process_rows(batch_size)
        self.rows = rows

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

    def position(self, epoch: int, batch_cursor: int) -> None:
        """The consumer's position: ``batch_cursor`` batches of ``epoch``
        consumed."""
        self._epoch, self._cursor = int(epoch), int(batch_cursor)

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
        gather = (self._native_gather
                  if self.use_native and not getattr(self.ds, "is_lazy",
                                                     False)
                  else self.ds.images.__getitem__)
        for lo in range(start * self.batch_size, stop, self.batch_size):
            sel = idx[lo:lo + self.batch_size][self.rows]
            yield gather(sel), self.ds.labels[sel]
        # Clean exhaustion moves to the next epoch; an abandoned iteration
        # never gets here.
        if epoch == self._epoch and start == self._cursor:
            self._epoch, self._cursor = epoch + 1, 0

    def _native_gather(self, sel: np.ndarray) -> np.ndarray:
        from distributed_model_parallel_tpu_torch.data import native

        return native.gather_rows(self.ds.images, sel,
                                  n_threads=self.num_workers)


class PrefetchLoader:
    """A host thread assembling the next ``depth`` batches of any batch
    iterable while the consumer runs the current one (the reference's
    DataLoader workers, ``data_parallel.py:44-51``). A worker's exception
    reaches the consumer after the batches already buffered; a consumer
    that abandons the iteration (a preemption's break, an exception in
    the step) stops the worker within one poll and waits at most
    ``join_timeout_s`` for it; a worker that dies without a result is
    detected instead of waited for."""

    def __init__(self, loader: Iterable, depth: int = 2, *,
                 join_timeout_s: float = 5.0):
        self.loader = loader
        self.depth = depth
        self.join_timeout_s = join_timeout_s

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            it = iter(self.loader)
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True,
                             name="dmp-prefetch")
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.5)
                except queue.Empty:
                    if t.is_alive():
                        continue
                    # The worker may have queued its last item between the
                    # timeout and the liveness check.
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        if err:
                            raise err[0] from None
                        raise RuntimeError("prefetch worker died without a "
                                           "result or sentinel") from None
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join(self.join_timeout_s)
        if err:
            raise err[0]


def to_device(arrays, device) -> list:
    """Host arrays as tensors on ``device``: pinned and asynchronous on
    the card, so an upload does not wait for the steps already queued;
    on the CPU no copy."""
    device = torch.device(device)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" else t.to(device))
    return out


class DevicePrefetchLoader:
    """Batches of a host iterable on ``device``, ``depth`` uploads ahead
    of the consumer. On the card each batch is copied from pinned memory
    on a side stream; before a batch is yielded the consumer's stream
    waits for its copy (an event recorded after it) and every tensor is
    ``record_stream``-ed on the consumer's stream, so the allocator does
    not hand its memory out again while steps still read it. On the CPU
    batches pass through as tensors. ``last_stats``: uploads issued and
    the most batches uploaded ahead of the one consumed."""

    def __init__(self, loader: Iterable, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"device prefetch depth must be >= 1, "
                             f"got {depth}")
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.last_stats = {"puts": 0, "max_lead": 0}

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        stats = {"puts": 0, "max_lead": 0}
        self.last_stats = stats
        cuda = self.device.type == "cuda"
        copy = torch.cuda.Stream(self.device) if cuda else None
        it = iter(self.loader)
        buf: list = []          # (tensors, copy-done event), not consumed
        exhausted = False
        try:
            while True:
                while not exhausted and len(buf) <= self.depth:
                    try:
                        batch = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    if cuda:
                        with torch.cuda.stream(copy):
                            tensors = to_device(batch, self.device)
                            done = copy.record_event()
                    else:
                        tensors, done = to_device(batch, self.device), None
                    buf.append((tensors, done))
                    stats["puts"] += 1
                if not buf:
                    return
                stats["max_lead"] = max(stats["max_lead"], len(buf) - 1)
                tensors, done = buf.pop(0)
                if cuda:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(done)
                    for t in tensors:
                        t.record_stream(compute)
                yield tuple(tensors)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def input_stream(loader: Iterable, device, prefetch: int,
                 device_prefetch: int) -> Iterable:
    """The trainers' input pipeline: host assembly behind a
    :class:`PrefetchLoader` (``prefetch > 0``) feeding a
    :class:`DevicePrefetchLoader` (``device_prefetch > 0``) or a plain
    upload a batch; yields ``(images, labels)`` tensors on ``device``."""
    host = PrefetchLoader(loader, depth=prefetch) if prefetch > 0 else loader
    if device_prefetch > 0:
        return DevicePrefetchLoader(host, device, depth=device_prefetch)
    return (tuple(to_device(batch, device)) for batch in host)


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


def resize_batch(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC uint8 ``[B, H, W, C]`` -> ``[B, size, size, C]`` uint8 on the
    images' device: bilinear with half-pixel centres, antialiased when it
    shrinks (as ``jax.image.resize`` is), rounded half to even, clipped
    to [0, 255]. The native size returns the input itself."""
    b, h, w, c = images_u8.shape
    if (h, w) == (size, size):
        return images_u8
    x = images_u8.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=size < h or size < w)
    return y.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


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
