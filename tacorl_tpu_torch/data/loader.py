"""Host-side batching and the copy to the device (port of
tacorl_tpu/data/loader.py).

``DataLoader`` is the JAX package's: a thread-pooled sampler feeding a
bounded prefetch queue; batches are dicts of numpy arrays whose every
random draw is keyed by ``(seed, epoch, batch_idx[, idx])``, so they are
bit-equal to the JAX package's and independent of the thread count. With
``shard`` a rank's ``parallel.mesh.BatchShard`` (the trainer sets it), each
batch is that rank's rows of the global batch of ``batch_size`` rows,
equal to those rows of the one-process batch: the index order and the
per-batch keys are the global batch's, and a rank reads only its rows.
With ``pin_memory`` set, the training thread never pins: a dataset with a
batched path (``sample_batch``, packed storage) assembles each batch in
place in page-locked tensors from torch's caching host allocator, and the
loader's threads copy what is left (every leaf of any other dataset) into
such tensors. ``DevicePut`` copies from those very tensors, so each copy
records its event with the allocator, which hands a block to a later batch
only once the copies that read it have run.

``device_prefetch`` keeps ``depth`` batches in flight: ``put_fn`` runs on the
next host batch while the current one computes. ``DevicePut`` is the
``put_fn`` of a device: on a card it starts ``non_blocking`` copies of a
(pinned) batch on its own side stream and records an event after them;
``DevicePut.ready`` (called by ``device_prefetch`` as it hands a batch out)
makes the consumer's current stream wait for that event and marks each
tensor with ``record_stream``, so the caching allocator does not reuse its
memory while the consumer's kernels may still read it. On the CPU it is
``torch.as_tensor`` of each leaf. A list of K batches (a chunk of the
trainer's K-step dispatch) is put as one batch whose leaves are stacked
(K, B, ...): on a card each batch is copied into its slice of the stacked
device tensor, so nothing is stacked on the host.

Spans (``utils/profiling.spans``, kept while the recorder is on), each
carrying its batch's ``epoch`` and ``batch`` index: ``loader/produce`` on a
pool thread around a batch's making, with ``loader/pin`` inside it (and
the dataset's ``loader/draws``, ``loader/gather``, ``loader/pad``); on the
consumer's thread ``loader/wait`` around the wait for each handed-out
batch, with the counter ``loader/ready`` (how many queued batches were
done at the hand-out), and ``loader/put`` around ``DevicePut``'s enqueue
(``first`` and ``last`` batch of the chunk). The counter ``loader/in_place``
(pool thread, one a batch) is the share of the batch's bytes that were
written straight into page-locked memory.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

from tacorl_tpu_torch.parallel.mesh import BatchShard
from tacorl_tpu_torch.utils import resolve_device
from tacorl_tpu_torch.utils.profiling import RECORDER, count, last_ids, spans

__all__ = ["collate", "DataLoader", "device_prefetch", "DevicePut", "tree_map"]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """The (path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [pair for k, v in tree.items() for pair in flatten(v, path + (k,))]
    return [(path, tree)]


def unflatten(pairs) -> Any:
    """The nested dict of (path, leaf) pairs; an empty path is the root."""
    out: Dict = {}
    for path, leaf in pairs:
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _stack(fn: Callable[[list], Any], trees: Sequence[Any]) -> Any:
    """``fn`` over the list of matching leaves of trees of one structure."""
    flat = [flatten(t) for t in trees]
    return unflatten([(path, fn([f[i][1] for f in flat])) for i, (path, _) in enumerate(flat[0])])


def collate(items: Sequence[Dict]) -> Dict:
    """Stack a list of sample dicts into a dict-of-arrays batch (recursive)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    return np.stack(items)


def _page_locked(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_pinned()


def _torch_dtype(dtype: Union[np.dtype, torch.dtype]) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch.from_numpy(np.empty(0, dtype)).dtype


def _pinned_empty(shape: Tuple[int, ...], dtype: Union[np.dtype, torch.dtype]) -> torch.Tensor:
    """A page-locked tensor of ``shape`` and ``dtype`` (numpy's or torch's),
    from torch's caching host allocator: a block recycled once the copies
    that read its last tenant have run."""
    return torch.empty(shape, dtype=_torch_dtype(dtype), pin_memory=True)


def _pinned(x: Any) -> torch.Tensor:
    """``x`` itself when it is a page-locked tensor, else a page-locked copy
    of it (the copy runs without the GIL)."""
    if _page_locked(x):
        return x
    src = torch.as_tensor(x)
    return _pinned_empty(tuple(src.shape), src.dtype).copy_(src)


def _in_place_share(batch: Any) -> float:
    """The share of the batch's bytes in page-locked tensors."""
    leaves = [x for _, x in flatten(batch)]
    total = sum(x.nbytes for x in leaves)
    return sum(x.nbytes for x in leaves if _page_locked(x)) / total if total else 0.0


class DataLoader:
    """Iterates shuffled (or sequential) batches of ``dataset.sample(idx, rng)``
    items. ``percentage`` keeps the leading fraction of indices, matching the
    reference's Subset behavior (basic_data_module.py:111-123)."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        percentage: float = 1.0,
        prefetch: int = 2,
        num_threads: int = 2,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.n = int(len(dataset) * percentage)
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.pin_memory = pin_memory
        self.shard = BatchShard()
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict]:
        order = self._index_order()
        self.epoch += 1
        epoch = self.epoch
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, self.n, self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        pin, shard = self.pin_memory, self.shard

        def produce(batch_idx: int, indices: np.ndarray) -> Dict:
            with spans("loader/produce", epoch=epoch, batch=batch_idx):
                rows = shard.rows(len(indices))
                # packed-storage datasets expose a native batched gather
                if getattr(self.dataset, "supports_batch", lambda: False)():
                    rng = np.random.default_rng((self.seed, epoch, batch_idx))
                    # on a card the batch is assembled in page-locked memory
                    batch = self.dataset.sample_batch(indices, rng, rows, alloc=_pinned_empty if pin else np.empty)
                else:
                    items = []
                    for idx in indices[rows]:
                        rng = np.random.default_rng((self.seed, epoch, batch_idx, int(idx)))
                        items.append(self.dataset.sample(int(idx), rng))
                    batch = collate(items)
                if RECORDER.on:
                    count("loader/in_place", _in_place_share(batch), epoch=epoch, batch=batch_idx)
                if pin:
                    with spans("loader/pin"):
                        batch = tree_map(_pinned, batch)
                return batch

        if self.prefetch <= 0:
            for bi, b in enumerate(batches):
                yield produce(bi, b)
            return

        if self.num_threads > 1:
            # pooled producers (reference: num_workers DataLoader processes,
            # basic_data_module.py:132-158); threads suffice because the
            # gathers, npz decodes and pinning copies release the GIL, and
            # the per-batch RNG keys make the values independent of the pool
            yield from self._iter_pooled(batches, produce, epoch)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for bi, b in enumerate(batches):
                    if stop.is_set():
                        return
                    q.put(produce(bi, b))
            except Exception as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_pooled(self, batches, produce, epoch: int) -> Iterator[Dict]:
        window = self.prefetch + self.num_threads
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        # (batch index, future) of each submitted batch not yet handed out
        pending: "collections.deque" = collections.deque()
        try:
            it = iter(enumerate(batches))
            exhausted = False
            while True:
                while not exhausted and len(pending) < window:
                    try:
                        bi, b = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append((bi, pool.submit(produce, bi, b)))
                if not pending:
                    return
                bi = pending[0][0]
                if RECORDER.on:
                    count("loader/ready", sum(f.done() for _, f in pending), epoch=epoch, batch=bi)
                with spans("loader/wait", epoch=epoch, batch=bi):
                    pending[0][1].result()
                # no local keeps the batch (or its future) while the consumer has it
                yield pending.popleft()[1].result()
        finally:
            # the consumer may abandon the iterator early: cancel the queued
            # produce() calls and do not block on the running ones. Only the
            # futures' and the pool's own state is touched, so this also
            # holds when the iterator is closed at interpreter exit, after
            # the modules' globals were cleared (pool.shutdown's
            # cancel_futures reads concurrent.futures' module globals)
            for _, future in pending:
                future.cancel()
            pool.shutdown(wait=False)


class _OnDevice:
    """A batch whose copies were queued on the side stream, and the event
    recorded after them."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event):
        self.tree, self.event = tree, event


class DevicePut:
    """``put_fn`` moving a nested batch (numpy arrays or pinned tensors) to
    ``device``; see the module docstring."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch: Any) -> Any:
        if isinstance(batch, list):
            return self._put_chunk(batch)
        with spans("loader/put", **_chunk_ids(1)):
            if self.stream is None:
                return tree_map(torch.as_tensor, batch)
            with torch.cuda.stream(self.stream):
                tree = tree_map(
                    lambda x: torch.as_tensor(x).to(self.device, non_blocking=True), batch
                )
                event = torch.cuda.Event()
                event.record(self.stream)
            return _OnDevice(tree, event)

    def _put_chunk(self, batches: list) -> Any:
        def put(xs):
            first = torch.as_tensor(xs[0])
            out = torch.empty((len(xs),) + tuple(first.shape), dtype=first.dtype, device=self.device)
            for i, x in enumerate(xs):
                out[i].copy_(torch.as_tensor(x), non_blocking=True)
            return out

        with spans("loader/put", **_chunk_ids(len(batches))):
            if self.stream is None:
                return _stack(lambda xs: torch.stack([torch.as_tensor(x) for x in xs]), batches)
            with torch.cuda.stream(self.stream):
                tree = _stack(put, batches)
                event = torch.cuda.Event()
                event.record(self.stream)
            return _OnDevice(tree, event)

    def ready(self, put: Any) -> Any:
        """The batch, usable on the current stream."""
        if not isinstance(put, _OnDevice):
            return put
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(put.event)
        tree_map(lambda t: t.record_stream(stream), put.tree)
        return put.tree


def _chunk_ids(n: int) -> Dict[str, int]:
    """The ids of the ``n`` batches this thread was handed last (a chunk
    never spans two epochs): its last ``loader/wait``'s epoch, and the
    chunk's first and last batch index; {} when the recorder is off or no
    batch was handed out through a pooled loader."""
    if not RECORDER.on:
        return {}
    ids = last_ids("loader/wait")
    if not ids:
        return {}
    return {"epoch": ids["epoch"], "first": ids["batch"] - n + 1, "last": ids["batch"]}


def device_prefetch(iterator: Iterator, put_fn: Callable[[Any], Any], depth: int = 1):
    """Keep ``depth`` batches in flight on the device: ``put_fn`` runs on the
    next host batch while the current device batch computes; a ``put_fn``
    with a ``ready`` method gets each batch back through it as it is handed
    out."""
    ready = getattr(put_fn, "ready", lambda b: b)
    buf = collections.deque()
    for batch in iterator:
        buf.append(put_fn(batch))
        if len(buf) > depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())
