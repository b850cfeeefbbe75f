"""Sharded mapper step + coverage all-reduce on torch.distributed — the
counterpart of gnumap_tpu/dist/collectives.py.

The reference's MPI layer (read partitioning, genome-partitioned index,
final MPI_Reduce of coverage — SURVEY.md §3.5) as the device program of
pipeline/mapper.py run by every rank of a reads x index mesh (dist/mesh.py:
rank r * S + s holds reads block r and index shard s):

  * reads sharded over axis "reads": seeding and DP of a reads block need
    no communication, exactly like the reference's read-partitioned mode;
  * index sharded by k-mer range over axis "index" (config 5): every rank of
    an index group holds the same reads block and one CSR shard.  Each rank
    looks up only the k-mers it owns (one integer divide routes a query —
    k-mer codes are range-partitioned, no hashing) and the hit tables merge
    with ONE all_reduce(SUM) over "index" (+1 encoding so missing hits are
    the additive identity).  Candidate slots are then split across the
    index group, so the DP cost is divided by the number of index shards,
    and the scores are re-joined with an all_gather in index order;
  * device finish: each reads block runs the device tail (retention,
    csrc/nw_pure.cu, csrc/nw_tb.cu, the blob), the fixed-length blobs are
    all_gathered over "reads", and every rank decodes all of them;
  * coverage arrays merge with all_reduce over both axes (the MPI_Reduce
    analog, BASELINE.json:5 "cross-host posterior merge").

``DistMapper.map_batch`` takes the global batch on every rank and returns
the global per-read hits on every rank, as the JAX ``map_batch`` returns
global outputs.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from gnumap_tpu_torch.align import scoring
from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.dist.mesh import INDEX_AXIS, READS_AXIS, Mesh
from gnumap_tpu_torch.index import store
from gnumap_tpu_torch.index.builder import BsIndexPair, Genome
from gnumap_tpu_torch.io.fastq import ReadBatch
from gnumap_tpu_torch.pipeline import mapper as pl
from gnumap_tpu_torch.pipeline.mapper import SENTINEL


class DistMapper:
    """Sharded device map: reads over "reads", CSR index over "index", one
    rank per mesh position.  Every rank keeps its own index shard (the whole
    table when S == 1), the genome and the scoring tables on its device.

    ``finish_impl="device"`` (the default, None) runs the device tail per
    reads block and decodes the gathered blobs; ``"host"`` gathers
    [cands | scores | max_sc] and finishes on the host (pipeline/mapper.py
    host_finish).  It has no ``submit``: its collectives make each batch
    synchronous, and map_stream calls ``map_batch``."""

    def __init__(self, genome: Genome, index, cfg: MapperConfig, mesh: Mesh,
                 device=None, finish_impl: Optional[str] = None):
        kind = pl.index_kind(index)
        if kind.startswith("fm"):
            raise ValueError("--index-type fm is single-device; the sharded "
                             "path shards the CSR table (use --index-type "
                             "csr)")
        self.bisulfite = kind == "csr_bs"
        if cfg.bisulfite != self.bisulfite:
            raise ValueError("bisulfite mode requires (exactly) the "
                             "builder.build_bs_index collapsed pair")
        if index.mer_size != cfg.mer_size:
            raise ValueError("index mer_size != cfg.mer_size")
        self.finish_impl = "device" if finish_impl is None else finish_impl
        if self.finish_impl not in ("device", "host"):
            raise ValueError(f"finish_impl {finish_impl!r}: use 'device' or "
                             "'host'")
        self.cfg = cfg
        self.mesh = mesh
        self.genome = genome
        self.device = mesh.device if device is None else torch.device(device)
        if self.device != mesh.device:
            raise ValueError(f"device {self.device} is not the mesh rank's "
                             f"device {mesh.device}")
        S = mesh.shape[INDEX_AXIS]
        self.S = S
        if cfg.max_candidates % (S * 8):
            raise ValueError("max_candidates must divide by 8*index_shards")
        tables = [index.plus, index.minus] if self.bisulfite else [index]
        self.n_buckets = tables[0].n_buckets
        if S > 1:
            s = mesh.coords[1]
            tables = [store.shard_index(t, S)[s] for t in tables]
        local = BsIndexPair(*tables) if self.bisulfite else tables[0]
        self.S_plus_np, self.S_minus_np = scoring.matrices_for_mode(cfg)
        self.state = pl.device_state(genome, local, cfg, self.device)

    # ------------------------------------------------------------------
    def _route_hits(self, km, bad, sfx):
        """Seed lookup on this rank's table (``sfx``: "" or "_minus");
        with index shards, each rank looks up only the codes it owns and
        the hit tables merge with one all_reduce over "index" (+offset
        encoding: SENTINEL -> 0, the additive identity)."""
        cfg, st = self.cfg, self.state
        bs, pos = st["bucket_start" + sfx], st["positions" + sfx]
        if self.S == 1:
            return pl.csr_hits(km, bad, bs, pos, st["offsets"], cfg)
        s = self.mesh.coords[1]
        Q = -(-self.n_buckets // self.S)
        owned = (torch.div(km, Q, rounding_mode="floor") == s) & ~bad
        km_local = torch.where(owned, km - s * Q, 0)
        cand = pl.csr_hits(km_local, ~owned, bs, pos, st["offsets"], cfg)
        off = cfg.max_read_len + 1
        enc = torch.where(cand == SENTINEL, 0, cand + off)
        enc = self.mesh.all_reduce(enc, "sum", INDEX_AXIS)
        return torch.where(enc == 0, SENTINEL, enc - off)

    def _seed(self, codes2):
        cands = pl.dedupe_cap(pl.seed_csr(self.cfg, self.state, codes2,
                                          self._route_hits),
                              self.cfg.max_candidates)
        return cands, cands != SENTINEL

    def _score(self, emis2_t, cands, lens2):
        """This rank's C / S candidate slots scored (csrc/nw_band.cu, or
        csrc/nw_full.cu without a band), re-joined over "index" in index
        order."""
        g = self.state["g_codes"]
        if self.S == 1:
            return pl.score_pairs(self.cfg, emis2_t, cands, lens2, g)
        Cs = self.cfg.max_candidates // self.S
        s = self.mesh.coords[1]
        sc = pl.score_pairs(self.cfg, emis2_t,
                            cands[:, s * Cs:(s + 1) * Cs].contiguous(),
                            lens2, g)
        return torch.cat(self.mesh.all_gather(sc, INDEX_AXIS), dim=1)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _shard_core(self, batch: ReadBatch):
        """This rank's reads block through the map program: (cands, valid,
        scores, max_sc, emis2_t, lens2) of its 2 * B / R read-strands.
        Quality-derived batches ship (quals, packed codes) and rebuild the
        PWM on the device, as TorchMapper does."""
        lo, hi = self.mesh.batch_range(batch.codes.shape[0])
        st = self.state
        lens = self._to_device(np.asarray(batch.lens[lo:hi], np.int32))
        if batch.pwm_arr is None:
            codes, quals = pl.device_unpack(
                self._to_device(pl.pack_reads(batch.codes[lo:hi],
                                              batch.quals[lo:hi])),
                self.cfg.max_read_len)
            pwm_q = pl.device_pwm(codes, quals, lens, st["pwm_table"])
        else:
            codes = self._to_device(np.asarray(batch.codes[lo:hi], np.int8))
            pwm_q = self._to_device(np.asarray(batch.pwm_arr[lo:hi],
                                               np.int32))
        return pl.device_map(self.cfg, st, codes, pwm_q, lens, self._seed,
                             self._score)

    # ------------------------------------------------------------------
    def _canonical_perm(self, B: int) -> np.ndarray:
        """The gathered blocks stack each block's [+ rows, - rows]; the
        permutation to the canonical layout (all + rows, then all -)."""
        R = self.mesh.shape[READS_AXIS]
        Bloc = B // R
        perm = np.empty(2 * B, np.int64)
        for r in range(R):
            base = r * 2 * Bloc
            perm[r * Bloc:(r + 1) * Bloc] = np.arange(base, base + Bloc)
            perm[B + r * Bloc:B + (r + 1) * Bloc] = np.arange(
                base + Bloc, base + 2 * Bloc)
        return perm

    def _map_batch_devtb(self, batch: ReadBatch, stats=None):
        """Device-finish path: each reads block emits the compact blob, the
        blobs are gathered over "reads" and every rank decodes them block by
        block.  Returns None on any block's capacity overflow, decided the
        same way on every rank (a MAX all_reduce of the flag), so that all
        ranks enter the fallback's collectives together."""
        cfg = self.cfg
        B = batch.codes.shape[0]
        R = self.mesh.shape[READS_AXIS]
        Bloc = B // R
        t0 = time.perf_counter()
        blob = pl.device_tb_tail(cfg, *self._shard_core(batch),
                                 self.state["g_codes"])
        blobs = torch.stack(self.mesh.all_gather(blob, READS_AXIS))
        blob_all = blobs.cpu().numpy()
        t1 = time.perf_counter()
        assert blob_all.shape == (R, pl.tb_blob_len(cfg, Bloc))
        H = cfg.hit_capacity * 2 * Bloc
        over = bool(((blob_all[:, -3] > H)
                     | (blob_all[:, -1] > max(64, H // 32))).any())
        flag = self.mesh.all_reduce(
            torch.tensor([int(over)], dtype=torch.int32, device=self.device),
            "max")
        if int(flag.item()):
            return None
        out: List[List[pl.ReadHit]] = [[] for _ in range(batch.n)]
        n_valid_tot = 0
        for r in range(R):
            lo = r * Bloc
            n_loc = max(0, min(batch.n - lo, Bloc))
            part, _, n_valid = pl.decode_tb_blob(
                cfg, Bloc, n_loc, batch.lens[lo:lo + Bloc], blob_all[r])
            n_valid_tot += n_valid
            for b, hits in enumerate(part.to_lists()):
                out[lo + b] = hits
        if stats is not None:
            pl._update_stats(stats, cfg, batch, out, n_valid_tot, t1 - t0,
                             time.perf_counter() - t1)
        return out

    def _map_batch_host(self, batch: ReadBatch, stats=None):
        """Host-finish path: [cands | scores | max_sc] of every reads block
        gathered over "reads", then the host finish on the canonical rows."""
        cfg = self.cfg
        B = batch.codes.shape[0]
        t0 = time.perf_counter()
        cands, _, scores, max_sc, _, _ = self._shard_core(batch)
        packed = torch.cat([cands, scores, max_sc[:, None]], dim=1)
        allp = torch.cat(self.mesh.all_gather(packed, READS_AXIS))
        arr = allp.cpu().numpy()[self._canonical_perm(B)]
        t1 = time.perf_counter()
        outputs = pl.TorchMapper.unpack_blob(arr, cfg.max_candidates)
        out = pl.host_finish(self.genome, self.S_plus_np, self.S_minus_np,
                             cfg, batch, *outputs)
        if stats is not None:
            pl._update_stats(stats, cfg, batch, out, int(outputs[1].sum()),
                             t1 - t0, time.perf_counter() - t1)
        return out

    def map_batch(self, batch: ReadBatch,
                  stats: Optional[pl.BatchStats] = None
                  ) -> List[List[pl.ReadHit]]:
        """ReadBatch (global, on every rank) -> global per-read hits on
        every rank, the semantics of TorchMapper.map_batch (tested)."""
        self.mesh.batch_range(batch.codes.shape[0])   # B % R check
        if self.finish_impl == "device":
            out = self._map_batch_devtb(batch, stats)
            if out is not None:
                return out
            # capacity overflow in some block: exact host-finish fallback
        return self._map_batch_host(batch, stats)


def allreduce_coverage(local: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Merge per-rank coverage arrays: this rank's row (G,) -> the (G,)
    sum over every rank of the mesh.

    The MPI_Reduce analog: all_reduce over both mesh axes, in float64 on
    the rank's device; its summation order is the backend's (the exact,
    host-ordered merge is dist/multihost.allreduce_f64)."""
    t = torch.from_numpy(np.ascontiguousarray(local, np.float64)).to(
        mesh.device)
    return mesh.all_reduce(t, "sum").cpu().numpy()
