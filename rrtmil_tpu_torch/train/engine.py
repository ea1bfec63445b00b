"""Training and evaluation engine over bucketed bags.

Counterpart of `rrtmil_tpu/train/engine.py` for the classification path:
`EngineConfig`, `_batched_order` (greedy bucket-aware batching that keeps
the given order within a bucket), batch assembly (`_make_batch`, three
tiers as in engine.py:334-356: the device bag cache; else the native
loader; else the Python route with the shuffle augmentations and the
transfer dtype's cast; then the transfer), `_batch_iter` (next-batch
assembly in threads while the device runs the current one), `train_epoch`
(`_train_step` and `_apply_grads`: per-step learning rate, global-norm
clipping, gradient accumulation with the loss pre-scaled by
1/accumulation_steps and one update per window, the short tail window
included; the iteration meters through `logger`), `_eval_step` and
`evaluate`.  Per-step meters and per-batch results stay on the device and
are fetched at the log points and once per epoch.

Aux models (engine.py:176-200, `EngineConfig.aux_mode`): the train
forward gives (logits, aux, ps) and the loss is cls_alpha * loss(logits) +
aux_alpha * aux.  CLAM ('loss') takes the bag's label as a host int, read
from the dataset's `slide_label` beside the batch (no device sync), and
returns its instance loss; DSMIL ('logits') returns its max-instance
logits, which take the criterion.  ps, the bag's padded patch count, joins
the iteration meters.  `ds_average` evaluates DSMIL on the mean of the bag
and max-instance softmaxes.  A parameter the step's graph did not reach
gets a zero gradient before the update, as JAX's gradients are never
absent, except CLAM's instance classifiers, which keep `grad=None` and so
take no optimizer step (`optim.fill_unreached_grads`).

Exact mode (`EngineConfig.exact`, rrtmil_tpu/train/engine.py:73-74,347,
428-447,548; the
harness sets it for TransMIL, whose wrap-padding copies real tokens): one
bag a batch, padded to its true length with no bucketing, and the device
bag cache bypassed, as in the JAX package.

Random streams, as in the JAX package: `_rng` (numpy, seeded with
`cfg.seed`) draws the augmentations and, unless `fix_loader_random` pins it
to the reference's fixed loader seed, the train order too: one stream,
drawn in the JAX package's order.  Dropout masks come from the engine's
`torch.Generator` (seeded with `cfg.seed`, on the engine's device).

The native tier (engine.py:457-543, data/native_loader.py) serves a batch
whose files the C++ loader reads as the Python route does: a dataset with
`slide_path`, no `persistence`, `keep_same_psize` or `max_patch`, no
augmentation or exact mode, and C-order 2-D `<f4` / `<f2` `.npy` files
(`native_ok`; JAX checks no dtype, so there a `<f8` file fails mid-epoch,
here it takes the Python route, which gives JAX's Python result).  Its C++
threads write the transfer dtype (bfloat16 under --amp, no host cast pass)
into a per-thread staging buffer, pinned on a CUDA engine, whose copies
to the device are asynchronous; a CUDA event recorded after them is waited
on before the buffer is filled again (a CPU engine fills a fresh buffer
each batch: there the transfer is no copy).  The Python route copies from
pageable memory.  `tier_batches` counts the batches each tier served
('cache': every bag a hit; 'native' / 'python': a host tier assembled the
batch's missing bags).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RRTEncoderConfig
from ..data import augment, native_loader
from ..data.bucketing import BucketSpec, bucket_for, pad_bag
from ..data.device_cache import DeviceBagCache, cacheable
from ..utils.device import resolve_device
from .losses import bce_with_logits, cross_entropy
from .optim import fill_unreached_grads, lr_at, make_optimizer

# the reference's fixed DataLoader generator seed (main.py:125-130)
FIXED_LOADER_SEED = 7784414403328510413
_TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class EngineConfig:
    loss: str = "ce"                 # 'ce' | 'bce'
    opt: str = "adam"
    lr: float = 2e-4
    weight_decay: float = 1e-5
    lr_schedule: str = "cosine"
    lr_supi: bool = False            # step the schedule per iteration
    num_epochs: int = 200
    batch_size: int = 1
    n_classes: int = 2
    cls_alpha: float = 1.0
    aux_alpha: float = 1.0
    accumulation_steps: int = 1
    clip_grad: float = 0.0
    patch_shuffle: bool = False      # train-bag augmentations (reference
    group_shuffle: bool = False      # utils.py:26-70), drawn from `_rng`
    shuffle_group: int = 0
    seed: int = 2021
    fix_loader_random: bool = False  # train order from the reference's fixed
    # loader seed instead of `_rng` (forced on for camelyon16, main.py:731)
    log_iter: int = 100  # iteration-meter period (reference main.py:476-490)
    num_workers: int = 2  # batch assemblies run ahead of the device step (0:
    # serial); clamped to 1 while augmentation draws from `_rng`, so the
    # stream is drawn in the serial loop's order
    transfer_dtype: str = "float32"  # 'bfloat16' with --amp: the host casts
    # each bag before the transfer, halving its bytes
    device_cache: str = "auto"  # bags kept on the device after their first
    # transfer (data/device_cache.py): 'on' | 'off' | 'auto' (= on when the
    # engine's device is CUDA); bypassed while augmentation is on
    device_cache_bytes: int = 6 << 30  # its budget; bags past it stream
    aux_mode: Optional[str] = None  # None | 'loss' (CLAM) | 'logits' (DSMIL)
    ds_average: bool = False  # DSMIL evaluation: probabilities are the mean
    # of the bag and max-instance softmaxes (the reference's intended
    # --ds_average, main.py:526,531-541); needs aux_mode='logits'
    exact: bool = False  # pad each bag to its true length (no bucketing),
    # one bag a batch, no device cache: TransMIL's wrap-padding


class Engine:
    """Drives one model through train and eval epochs on `device` (the card
    by default; raises when there is none unless device='cpu').  The
    harness sets `logger` (utils/logger.Logger) and `fold` for the
    iteration meters."""

    def __init__(self, model: torch.nn.Module, cfg: EngineConfig,
                 encoder_cfg: Optional[RRTEncoderConfig] = None,
                 device="cuda"):
        if cfg.transfer_dtype not in _TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype {cfg.transfer_dtype!r} is not "
                             f"one of {sorted(_TRANSFER_DTYPES)}")
        if cfg.ds_average and cfg.aux_mode != "logits":
            raise ValueError("ds_average requires a model that returns "
                             "max-instance logits (aux_mode='logits')")
        if cfg.aux_mode is not None and cfg.batch_size != 1:
            raise ValueError(f"aux_mode {cfg.aux_mode!r} models take one bag "
                             f"at a time: batch_size must be 1")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.encoder_cfg = encoder_cfg or RRTEncoderConfig()
        self.optimizer = make_optimizer(cfg.opt, self.model.parameters(),
                                        cfg.lr, cfg.weight_decay)
        self._loss = cross_entropy if cfg.loss == "ce" else bce_with_logits
        self.global_iter = 0
        self.last_ps = 0
        self.logger = None
        self.fold = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._order_rng = (np.random.default_rng(FIXED_LOADER_SEED)
                           if cfg.fix_loader_random else self._rng)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._dcache: Optional[DeviceBagCache] = None
        self._dcache_lock = threading.Lock()   # prefetch threads race init
        self._staging = threading.local()      # a native buffer a thread
        self.tier_batches = {"cache": 0, "native": 0, "python": 0}

    def reseed(self, seed: int) -> None:
        """Re-pin the numpy streams (fix_train_random: the reference re-runs
        seed_torch(args.seed) right before the epoch loop, main.py:254-255,
        so every fold draws the same augmentation and order streams)."""
        self._rng = np.random.default_rng(seed)
        if not self.cfg.fix_loader_random:
            self._order_rng = self._rng

    def close(self) -> None:
        """Release the fold's device bag cache, so the next fold's bags never
        compete with this one's for the byte budget."""
        if self._dcache is not None:
            self._dcache.clear()
            self._dcache = None

    # -- batching ----------------------------------------------------------

    def _batched_order(self, dataset, order: Sequence[int]) -> List[List[int]]:
        """Greedy bucket-aware batching that preserves the given order within
        each bucket.  batch_size=1 (forced in exact mode) degenerates to the
        reference's order."""
        bsz = 1 if self.cfg.exact else self.cfg.batch_size
        if bsz <= 1:
            return [[i] for i in order]
        length_of = getattr(dataset, "length",
                            lambda i: np.asarray(dataset[i][0]).shape[0])
        pending: Dict[Tuple, List[int]] = {}
        batches: List[List[int]] = []
        for i in order:
            spec = bucket_for(length_of(i), self.encoder_cfg)
            q = pending.setdefault(spec.key, [])
            q.append(i)
            if len(q) == bsz:
                batches.append(q.copy())
                q.clear()
        for q in pending.values():
            if q:
                batches.append(q)
        return batches

    def _augmented(self, train: bool) -> bool:
        return train and (self.cfg.patch_shuffle or self.cfg.group_shuffle)

    def _assemble_host(self, dataset, indices: Sequence[int], train: bool):
        """(x, mask, labels, spec) numpy arrays on the host, x float32; the
        train bags shuffled by `_rng` when augmentation is on; in exact mode
        padded to the longest bag's true length, which is also `length`."""
        shuffle = None
        if self._augmented(train):
            shuffle = (augment.patch_shuffle if self.cfg.patch_shuffle
                       else augment.group_shuffle)
        bags, labels, lengths = [], [], []
        for i in indices:
            bag, label = dataset[i]
            bag = np.asarray(bag, dtype=np.float32)
            if bag.ndim == 3:
                bag = bag[0]
            if shuffle is not None:
                bag = shuffle(bag, self.cfg.shuffle_group, self._rng)
            bags.append(bag)
            labels.append(label)
            lengths.append(bag.shape[0])
        if self.cfg.exact:
            n = max(lengths)
            spec = BucketSpec(key=(n,), repr_length=n, data_length=n)
        else:
            spec = bucket_for(max(lengths), self.encoder_cfg)
        xs, masks = zip(*[pad_bag(b, spec.data_length) for b in bags])
        return (np.stack(xs), np.stack(masks),
                np.asarray(labels, dtype=np.int64), spec)

    def native_ok(self, dataset, indices: Sequence[int],
                  train: bool) -> bool:
        """JAX's `_can_use_native` (engine.py:457-476), and the header's
        dtype and order besides: True when the native tier takes the
        batch."""
        paths = getattr(dataset, "slide_path", None)
        if paths is None or self._augmented(train) or self.cfg.exact:
            return False
        if getattr(dataset, "persistence", False) or \
                getattr(dataset, "keep_same_psize", 0) > 0 or \
                getattr(dataset, "max_patch", -1) > 0:
            return False
        return all(native_loader.eligible(paths[i]) for i in indices)

    def _count(self, tier: str) -> None:
        with self._dcache_lock:
            self.tier_batches[tier] += 1

    def _staging_buffers(self, b: int, rows: int, cols: int):
        """(x (b, rows, cols) in the transfer dtype, mask (b, rows) bool,
        labels (b,) int64) on one host buffer: this thread's pinned one on
        a CUDA engine, once the copies from its last fill are done; a new
        one on the CPU."""
        dt = _TRANSFER_DTYPES[self.cfg.transfer_dtype]
        nx = b * rows * cols * dt.itemsize
        nl = -(-(nx + b * rows) // 8) * 8           # labels 8-byte aligned
        total = nl + 8 * b
        if self.device.type != "cuda":
            buf = torch.empty(total, dtype=torch.uint8)
        else:
            st = self._staging
            if getattr(st, "event", None) is not None:
                st.event.synchronize()
                st.event = None
            buf = getattr(st, "buf", None)
            if buf is None or buf.numel() < total:
                buf = st.buf = torch.empty(total, dtype=torch.uint8,
                                           pin_memory=True)
        return (buf[:nx].view(dt).view(b, rows, cols),
                buf[nx:nx + b * rows].view(torch.bool).view(b, rows),
                buf[nl:total].view(torch.int64))

    def _assemble_native(self, dataset, indices: Sequence[int]):
        """(x, mask, labels, spec) host tensors from the C++ loader, x in the
        transfer dtype, on this thread's staging buffer."""
        paths = [dataset.slide_path[i] for i in indices]
        spec = bucket_for(max(map(native_loader.num_rows, paths)),
                          self.encoder_cfg)
        cols = native_loader.header(paths[0])[0][1]
        x, mask, labels = self._staging_buffers(len(paths), spec.data_length,
                                                cols)
        xs = x.view(torch.int16).numpy().view(np.uint16) \
            if x.dtype == torch.bfloat16 else x.numpy()
        native_loader.fill_batch(paths, spec.data_length, cols, out=xs,
                                 dtype=self.cfg.transfer_dtype,
                                 mask=mask.numpy())
        labels.copy_(torch.tensor([dataset.slide_label[i] for i in indices]))
        return x, mask, labels, spec

    def _host_batch(self, dataset, indices: Sequence[int], train: bool):
        """(x, mask, labels, spec) host tensors, x in the transfer dtype,
        from the native tier when it takes the batch, else the Python
        route; the tier is counted."""
        if self.native_ok(dataset, indices, train):
            self._count("native")
            return self._assemble_native(dataset, indices)
        self._count("python")
        x, mask, labels, spec = self._assemble_host(dataset, indices, train)
        xt = torch.from_numpy(x).to(_TRANSFER_DTYPES[self.cfg.transfer_dtype])
        return xt, torch.from_numpy(mask), torch.from_numpy(labels), spec

    def _transfer(self, x, mask, labels, spec):
        """Host tensors -> device tensors; from a pinned staging buffer the
        copies are asynchronous."""
        dev = self.device
        nb = x.is_pinned()
        return (x.to(dev, non_blocking=nb), mask.to(dev, non_blocking=nb),
                labels.to(dev, non_blocking=nb), spec)

    def _staged(self, x) -> None:
        """After the transfers from this thread's pinned buffer: an event
        that its next fill waits on."""
        if x.is_pinned():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._staging.event = ev

    def _device_cache(self) -> Optional[DeviceBagCache]:
        mode = self.cfg.device_cache
        if mode == "off" or (mode == "auto" and self.device.type != "cuda"):
            return None
        if self._dcache is None:
            with self._dcache_lock:
                if self._dcache is None:
                    self._dcache = DeviceBagCache(self.cfg.device_cache_bytes)
        return self._dcache

    def _make_batch(self, dataset, indices: Sequence[int],
                    train: bool = False):
        """One device batch (x, mask, labels, spec): from the device bag
        cache (a hit costs a `torch.cat` on the device), else assembled on
        the host and transferred."""
        cache = None
        if not (self._augmented(train) or self.cfg.exact) and \
                cacheable(dataset, train):
            cache = self._device_cache()
        if cache is not None:
            return self._make_batch_cached(dataset, indices, train, cache)
        return self._host_to_device(dataset, indices, train)

    def _host_to_device(self, dataset, indices, train: bool):
        host = self._host_batch(dataset, indices, train)
        out = self._transfer(*host)
        self._staged(host[0])
        return out

    def _make_batch_cached(self, dataset, indices, train: bool,
                           cache: DeviceBagCache):
        entries = {i: cache.get(dataset, i) for i in indices}
        missing = [i for i in indices if entries[i] is None]
        if missing:
            x, mask, labels, spec = self._host_batch(dataset, missing, train)
            for j, i in enumerate(missing):
                entries[i] = self._transfer(x[j:j + 1], mask[j:j + 1],
                                            labels[j:j + 1], spec)
                cache.put(dataset, i, *entries[i])
            self._staged(x)
        else:
            self._count("cache")
        if len({e[3].key for e in entries.values()}) != 1:
            # bags cached under different buckets: cannot happen with
            # bucket-grouped batches, but a hand-built mixed batch stays right
            return self._host_to_device(dataset, indices, train)
        if len(indices) == 1:
            return entries[indices[0]]
        parts = [entries[i] for i in indices]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]), parts[0][3])

    def _batch_iter(self, dataset, batches: List[List[int]], train: bool):
        """Yield device batches, assembling the next `num_workers` in threads
        while the device runs the current one (one while augmentation draws
        from `_rng`, so the stream is drawn in order)."""
        workers = self.cfg.num_workers
        if self._augmented(train):
            workers = min(workers, 1)
        if workers <= 0 or len(batches) <= 1:
            for b in batches:
                yield self._make_batch(dataset, b, train)
            return
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = deque()
            nxt = 0
            while nxt < len(batches) and len(pending) < workers:
                pending.append(pool.submit(self._make_batch, dataset,
                                           batches[nxt], train))
                nxt += 1
            while pending:
                cur = pending.popleft().result()
                if nxt < len(batches):
                    pending.append(pool.submit(self._make_batch, dataset,
                                               batches[nxt], train))
                    nxt += 1
                yield cur

    # -- train -------------------------------------------------------------

    def current_lr(self, epoch: int, iters_per_epoch: int) -> float:
        cfg = self.cfg
        if cfg.lr_supi:
            return lr_at(cfg.lr_schedule, cfg.lr, self.global_iter,
                         cfg.num_epochs * iters_per_epoch)
        return lr_at(cfg.lr_schedule, cfg.lr, epoch, cfg.num_epochs)

    def _forward_train(self, x, mask, labels, length: int,
                       label: Optional[int]):
        """(logits, aux loss or None, ps) of the train forward
        (engine.py:176-200)."""
        mode = self.cfg.aux_mode
        kwargs = {"label": label} if mode == "loss" else {}
        out = self.model(x, mask=mask, length=length,
                         generator=self.generator, **kwargs)
        if not isinstance(out, tuple):
            return out, None, 0
        ps = out[2] if len(out) > 2 else 0
        if mode == "loss":
            return out[0], out[1], ps
        if mode == "logits":
            return out[0], self._loss(out[1], labels), ps
        return out[0], None, 0

    def _train_step(self, x, mask, labels, length: int,
                    label: Optional[int] = None) -> torch.Tensor:
        """Forward and backward of one batch; the gradients add into .grad
        (accumulation).  `label` is the bag's label as a host int (CLAM's
        branch).  Returns the meters (total loss, logit loss[, aux loss]),
        on the device; the step's ps is kept in `last_ps`."""
        cfg = self.cfg
        logits, aux, self.last_ps = self._forward_train(x, mask, labels,
                                                        length, label)
        logit_loss = self._loss(logits, labels)
        total = cfg.cls_alpha * logit_loss
        if aux is not None:
            total = total + cfg.aux_alpha * aux
        if cfg.accumulation_steps > 1:
            total = total / cfg.accumulation_steps
        total.backward()
        meters = [total.detach(), logit_loss.detach()]
        if aux is not None:
            meters.append(aux.detach())
        return torch.stack(meters).float()

    def _host_label(self, dataset, indices) -> Optional[int]:
        """The bag's label as a host int for CLAM's branch, from the
        dataset's label list (no device sync)."""
        if self.cfg.aux_mode != "loss":
            return None
        return int(dataset.slide_label[indices[0]])

    def _apply_grads(self, lr: float) -> None:
        """One optimizer update at `lr`, after clipping the global gradient
        norm to clip_grad (scale min(1, clip / (norm + 1e-6)))."""
        cfg = self.cfg
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        fill_unreached_grads(self.model)
        if cfg.clip_grad > 0:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = torch.clamp(cfg.clip_grad / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def train_epoch(self, dataset, epoch: int,
                    order: Optional[Sequence[int]] = None) -> float:
        """One epoch in `order` (else a permutation from the order stream),
        bucket-batched; returns the mean total loss.  The meters are fetched
        at the log points and at the end."""
        cfg = self.cfg
        if order is None:
            order = self._order_rng.permutation(len(dataset))
        batches = self._batched_order(dataset, order)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        meters: List[torch.Tensor] = []
        synced: List[np.ndarray] = []
        ps: List[float] = []
        acc_n = 0
        for bi, (x, mask, labels, spec) in enumerate(
                self._batch_iter(dataset, batches, True)):
            lr = self.current_lr(epoch, len(batches))
            meters.append(self._train_step(
                x, mask, labels, spec.repr_length,
                label=self._host_label(dataset, batches[bi])))
            ps.append(float(self.last_ps))
            acc_n += 1
            # a short tail window gets its update too: its grads were
            # pre-scaled by 1/acc, so its bags weigh as loss/acc dictates
            if acc_n == cfg.accumulation_steps or bi == len(batches) - 1:
                self._apply_grads(lr)
                acc_n = 0
            self.global_iter += 1
            # log_iter <= 0 logs the last iteration only
            if self.logger is not None and (
                    (cfg.log_iter > 0 and bi % cfg.log_iter == 0)
                    or bi == len(batches) - 1):
                self._log_iteration(meters, synced, ps, bi, len(batches),
                                    lr)
        if meters:
            synced.append(torch.stack(meters).cpu().numpy())
        if not synced:
            return 0.0
        return float(np.concatenate(synced)[:, 0].mean())

    def _log_iteration(self, meters, synced, ps, bi: int, n_batches: int,
                       lr: float) -> None:
        """Iteration meters (reference main.py:471-490): the epoch-running
        means of the logit loss, the aux loss and the patch count, and the
        current lr, printed and logged under the fold's namespace.  Fetches
        only the steps since the last log point."""
        if meters:
            synced.append(torch.stack(meters).cpu().numpy())
            meters.clear()
        avg = np.concatenate(synced).mean(axis=0)
        aux = float(avg[2]) if avg.shape[0] > 2 else 0.0
        pn = float(np.mean(ps)) if ps else 0.0
        self.logger.print(f"[{bi}/{n_batches - 1}] logit_loss:{avg[1]:.4f}, "
                          f"cls_loss:{aux:.4f},  patch_num:{pn:.1f}, "
                          f"keep_num:{pn:.1f}, lr:{lr:.3e}")
        f = f"{self.fold}-fold"
        self.logger.log({f"{f}/cls_loss": float(avg[1]), f"{f}/lr": float(lr),
                         f"{f}/cl_loss": aux, f"{f}/patch_num": pn,
                         f"{f}/keep_num": pn}, commit=False)

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def _eval_step(self, x, mask, labels, length: int):
        out = self.model(x, mask=mask, length=length)
        logits = (out[0] if isinstance(out, tuple) else out).float()
        if self.cfg.ds_average:
            # loss on the bag logits; the probability averages the bag and
            # max-instance softmaxes (engine.py:305-318)
            losses = -F.log_softmax(logits, dim=-1).gather(
                1, labels[:, None])[:, 0]
            probs = 0.5 * torch.softmax(logits, dim=-1)[:, 1] + \
                0.5 * torch.softmax(out[1].float(), dim=-1)[:, 1]
            return probs, losses
        if self.cfg.loss == "ce":
            losses = -F.log_softmax(logits, dim=-1).gather(
                1, labels[:, None])[:, 0]
            return torch.softmax(logits, dim=-1)[:, 1], losses
        onehot = F.one_hot(labels, self.cfg.n_classes).float()
        losses = -torch.mean(onehot * F.logsigmoid(logits)
                             + (1 - onehot) * F.logsigmoid(-logits), dim=-1)
        return torch.sigmoid(logits)[:, 1], losses

    def evaluate(self, dataset, order: Optional[Sequence[int]] = None):
        """Returns (probs, labels, mean_loss) over the dataset, in batch
        order.  One host sync, after the last batch."""
        self.model.eval()
        order = list(order if order is not None else range(len(dataset)))
        batches = self._batched_order(dataset, order)
        probs_all, labels_all, losses_all = [], [], []
        for x, mask, labels, spec in self._batch_iter(dataset, batches,
                                                      False):
            probs, losses = self._eval_step(x, mask, labels, spec.repr_length)
            probs_all.append(probs)
            labels_all.append(labels)
            losses_all.append(losses)
        probs = torch.cat(probs_all).cpu().numpy()
        labels = torch.cat(labels_all).cpu().numpy()
        losses = torch.cat(losses_all).cpu().numpy()
        return probs, labels, float(np.mean(losses))
