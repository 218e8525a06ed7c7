"""NLOS pose datasets and the host input pipeline.

Port of ``hiddenpose_tpu/data/dataset.py``.  Sources are plain indexable
objects that return numpy samples:

* :class:`NlosPoseSource`: the pose_XX/{train,val,test}/{meas,vol,joints}
  walk, with the corrupt-file policy (a black or unreadable .hdr is
  replaced by sample 0 and logged to ``wrongMeasFiles.txt``) and the
  optional noise model of the reference's ``_noise`` dataloader;
* :class:`NlosFlatSource`: the flat-directory variant with .npy volumes;
* :class:`SyntheticSource`: the deterministic synthetic generator.

:class:`DataPipeline` batches a source in the JAX package's order exactly
(the same permutation per epoch, shard striding and ``drop_last``) through
a ``torch.utils.data.DataLoader`` over a batch sampler of those index
lists.  It takes the role of both the JAX package's thread pool and its
Grain pipeline (``data/grain_pipeline.py``, not ported: grain is not
installed where the port runs, and this loader gives worker processes,
prefetch and deterministic order).

Worker processes start by ``forkserver``, never by ``fork`` from the
loop's process: that one has CUDA up and OpenMP and PyTorch thread pools
running (the native decoder is OpenMP), and a forked child of such a
process may hang in them.  The fork server is a fresh interpreter, started
once per process, that imports this module (numpy, scipy, torch's CPU
side; never ``ops/kernels`` or CUDA) and the main module, runs nothing
and forks each worker: safe as ``spawn`` is, without each worker
importing torch again (on the GPU host a spawned worker took about 10 s
to come up).  A worker decodes and collates to CPU tensors; pinning
happens in the parent.  Workers are started once per pipeline and kept
across epochs (``close()`` stops them).  The fork server and its resource
tracker would otherwise outlive the process by a moment (each exits when
it reads the end of a pipe the process held): :func:`stop_worker_server`
stops both and waits for them, at exit or when called.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader

from hiddenpose_tpu_torch.data import preprocess as pp
from hiddenpose_tpu_torch.data import synthetic
from hiddenpose_tpu_torch.data.native_loader import DecodeError, library


class NlosPoseSource:
    """Indexable (meas, vol, joints, person_id) source over the pose_v2
    layout.  Builds the native decoder when created (raising if it cannot),
    so that the pipeline's workers find it built."""

    def __init__(self, cfg, datapath: str,
                 wrong_files_log: str = "wrongMeasFiles.txt"):
        self._setup(cfg, wrong_files_log)
        phase = cfg.dataset.phase
        self.meas_files: List[str] = []
        self.vol_files: List[str] = []
        self.joints_files: List[str] = []
        for pose_name in sorted(os.listdir(datapath)):
            pose_path = os.path.join(datapath, pose_name)
            if not os.path.isdir(pose_path):
                continue
            for split in sorted(os.listdir(pose_path)):
                if phase not in split:
                    continue
                split_path = os.path.join(pose_path, split)
                meas_dir = os.path.join(split_path, "meas")
                vol_dir = os.path.join(split_path, "vol")
                joints_dir = os.path.join(split_path, "joints")
                for name in sorted(os.listdir(meas_dir)):
                    stem, ext = os.path.splitext(name)
                    if ext != ".hdr":
                        raise ValueError(f"expected .hdr, got {name}")
                    vol_f = os.path.join(vol_dir, stem + ".mat")
                    joints_f = os.path.join(joints_dir, stem + ".joints")
                    for f in (vol_f, joints_f):
                        if not os.path.isfile(f):
                            raise FileNotFoundError(f"missing {f}")
                    self.meas_files.append(os.path.join(meas_dir, name))
                    self.vol_files.append(vol_f)
                    self.joints_files.append(joints_f)

    def _setup(self, cfg, wrong_files_log: str) -> None:
        self.cfg = cfg
        self.downsample_cnt = cfg.dataset.downsample_cnt
        self.noise = cfg.dataset.noise
        self.noise_sigma = cfg.dataset.noise_gaussian_sigma
        self.vol_size = cfg.dataset.vol_size[0]
        self.heatmap_size = cfg.dataset.heatmap_size[0]
        self.wrong_files_log = wrong_files_log
        library()

    def __len__(self) -> int:
        return len(self.meas_files)

    def _load_vol(self, path: str) -> np.ndarray:
        return pp.load_vol_mat(path)

    def _decode(self, meas_file: str) -> np.ndarray:
        gray = pp.decode_hdr_gray(meas_file)
        if self.noise:
            # the noise variant's order: gray -> blur + poisson -> /max
            noised = pp.add_noise(gray, self.noise_sigma)
            return noised / max(noised.max(), 1e-12)
        return gray

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        meas_file = self.meas_files[index]
        joints_file = self.joints_files[index]
        try:
            gray = self._decode(meas_file)
        except DecodeError:
            # the reference's policy: log the file, take sample 0 instead
            with open(self.wrong_files_log, "a") as f:
                f.write(meas_file + "\n")
            meas_file = self.meas_files[0]
            joints_file = self.joints_files[0]
            gray = self._decode(meas_file)

        meas = pp.preprocess_measurement(gray, self.downsample_cnt)
        vol = pp.downsample_volume(self._load_vol(self.vol_files[index]),
                                   self.downsample_cnt)
        joints = pp.map_joints_to_heatmap(
            np.loadtxt(joints_file), vol_size=self.vol_size,
            heatmap_size=self.heatmap_size)
        person_id = os.path.splitext(os.path.basename(meas_file))[0]
        return {
            "meas": meas[None].astype(np.float32),
            "vol": vol[None].astype(np.float32),
            "joints": joints.astype(np.float32),
            "person_id": person_id,
        }


class NlosFlatSource(NlosPoseSource):
    """Flat-directory variant: {meas/*.hdr, vol/*.npy, joints/*.joints}."""

    def __init__(self, cfg, datapath: str,
                 wrong_files_log: str = "wrongMeasFiles.txt"):
        self._setup(cfg, wrong_files_log)
        meas_dir = os.path.join(datapath, "meas")
        self.meas_files = [os.path.join(meas_dir, n)
                           for n in sorted(os.listdir(meas_dir))]
        self.vol_files = [f.replace("meas", "vol").rsplit(".", 1)[0] + ".npy"
                          for f in self.meas_files]
        self.joints_files = [
            f.replace("meas", "joints").rsplit(".", 1)[0] + ".joints"
            for f in self.meas_files]

    def _load_vol(self, path):
        return np.load(path).astype(np.float32)


class SyntheticSource:
    """Deterministic synthetic dataset (``data/synthetic.py``)."""

    def __init__(self, cfg, length: int = 16, seed: int = 410):
        m = cfg.model
        self.length = length
        self.seed = seed
        self.kw = dict(time_size=m.time_size, image_size=m.image_size[0],
                       grid=m.grid_dim, heatmap_size=m.heatmap_size[0],
                       bin_len=m.bin_len)

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return synthetic.make_sample(self.seed + index, **self.kw)


def collate(samples: Sequence[Dict[str, np.ndarray]]
            ) -> Dict[str, np.ndarray]:
    """Stack samples into the train-step batch dict: joints flattened to
    (B, J*3), all-ones visibility."""
    b = len(samples)
    joints = np.stack([s["joints"] for s in samples]).reshape(b, -1)
    return {
        "meas": np.stack([s["meas"] for s in samples]),
        "vol": np.stack([s["vol"] for s in samples]),
        "joints": joints.astype(np.float32),
        "joints_vis": np.ones_like(joints, dtype=np.float32),
        "person_id": [s["person_id"] for s in samples],
    }


def collate_tensors(samples) -> Dict:
    """:func:`collate` with CPU tensors for arrays (what a worker sends to
    the pipeline's process, through shared memory)."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in collate(samples).items()}


def stop_worker_server() -> None:
    """Stop this process's fork server and then its resource tracker (the
    server holds the tracker's pipe), waiting for each to exit.  A later
    pipeline with workers starts new ones."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class _EpochBatches:
    """Batch sampler: the pipeline's index lists for its current epoch,
    read when an epoch's iteration starts (in the pipeline's process)."""

    def __init__(self, pipeline: "DataPipeline"):
        self.pipeline = pipeline

    def __len__(self):
        return len(self.pipeline)

    def __iter__(self):
        return iter([b.tolist() for b in self.pipeline._index_batches()])


class DataPipeline:
    """Shuffling, batching iterator over a source, yielding dicts of CPU
    tensors (pinned when ``pin_memory``) and the ``person_id`` list.

    ``num_workers`` worker processes decode ahead, ``prefetch`` batches
    each; 0 loads in the calling process.  The order is the JAX
    pipeline's: a permutation by ``np.random.RandomState(seed + epoch)``,
    then each shard's strided, equal-length slice, then batches."""

    def __init__(self, source, batch_size: int, shuffle: bool = True,
                 seed: int = 410, num_workers: int = 8, prefetch: int = 2,
                 drop_last: bool = True, shard_index: int = 0,
                 shard_count: int = 1, pin_memory: bool = False):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.pin_memory = pin_memory
        self.epoch = 0
        self._loader = None

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch.  Iteration itself is pure: two passes at
        the same epoch yield the same order."""
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.source) // self.shard_count
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(len(self.source))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.shard_count > 1:
            # the same permutation on every shard; disjoint strided slices
            # of equal length, so every shard runs as many steps
            per_shard = len(idx) // self.shard_count
            idx = idx[self.shard_index::self.shard_count][:per_shard]
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _make_loader(self) -> DataLoader:
        kw = {}
        if self.num_workers > 0:
            ctx = multiprocessing.get_context("forkserver")
            # read when the fork server starts (the first pipeline's)
            ctx.set_forkserver_preload(["__main__", __name__])
            atexit.unregister(stop_worker_server)  # registered once
            atexit.register(stop_worker_server)
            kw = dict(multiprocessing_context=ctx,
                      prefetch_factor=self.prefetch, persistent_workers=True)
        return DataLoader(self.source, batch_sampler=_EpochBatches(self),
                          num_workers=self.num_workers,
                          collate_fn=collate_tensors,
                          pin_memory=self.pin_memory, **kw)

    def __iter__(self) -> Iterator[Dict]:
        if self._loader is None:
            self._loader = self._make_loader()
        return iter(self._loader)

    def close(self) -> None:
        """Stop the worker processes (a later iteration starts new ones)."""
        loader, self._loader = self._loader, None
        # DataLoader stops persistent workers only when its iterator is
        # collected; this is the method that collection calls
        it = getattr(loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
