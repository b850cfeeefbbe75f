"""Index persistence: save/load the packed genome + CSR seed table.

Reference analog: GNUMAP's optionally saved genome index (SURVEY.md §5
"Checkpoint / resume": the only persistent artifact).  Stored as compressed
npz — genome codes 2-bit packed with an N bitmask, CSR arrays verbatim.
Config 5 (sharded human-genome index) shards with ``shard_index``.
Four kinds: "csr", "csr_bs" (the bisulfite CSR pair), "fm" and "fm_bs" (the
FM index and its bisulfite pair, ``index/fm.py``), in the JAX package's file
format.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gnumap_tpu_torch.config import BASE_N
from gnumap_tpu_torch.core import packing
from gnumap_tpu_torch.index.builder import BsIndexPair, CsrIndex, Genome
from gnumap_tpu_torch.index.fm import FmBsPair, FmIndex

_FORMAT_VERSION = 1


def save_index(path: str, genome: Genome, index) -> None:
    """Persist genome + seed index (CSR or FM — ``kind`` field selects)."""
    n_mask = np.packbits(genome.codes == BASE_N)
    common = dict(
        version=np.int64(_FORMAT_VERSION),
        packed=packing.pack_2bit(genome.codes),
        n_mask=n_mask,
        n_bases=np.int64(len(genome.codes)),
        names=np.array(genome.names, dtype=object),
        starts=genome.starts, lengths=genome.lengths,
        mer_size=np.int64(index.mer_size))
    out = path if path.endswith(".npz") else path + ".npz"
    if isinstance(index, FmBsPair):
        np.savez_compressed(out, kind="fm_bs",
                            sa=index.plus.sa,
                            bwt_words=index.plus.bwt_words,
                            occ=index.plus.occ, c_table=index.plus.c_table,
                            sa_minus=index.minus.sa,
                            bwt_words_minus=index.minus.bwt_words,
                            occ_minus=index.minus.occ,
                            c_table_minus=index.minus.c_table, **common)
    elif isinstance(index, BsIndexPair):
        np.savez_compressed(out, kind="csr_bs",
                            bucket_start=index.plus.bucket_start,
                            positions=index.plus.positions,
                            bucket_start_minus=index.minus.bucket_start,
                            positions_minus=index.minus.positions,
                            **common)
    elif isinstance(index, FmIndex):
        np.savez_compressed(out, kind="fm", sa=index.sa,
                            bwt_words=index.bwt_words, occ=index.occ,
                            c_table=index.c_table, **common)
    else:
        np.savez_compressed(out, kind="csr",
                            bucket_start=index.bucket_start,
                            positions=index.positions, **common)


def load_index(path: str) -> Tuple[Genome, CsrIndex]:
    z = np.load(path, allow_pickle=True)
    if int(z["version"]) != _FORMAT_VERSION:
        raise ValueError(f"unsupported index version {int(z['version'])}")
    n = int(z["n_bases"])
    codes = packing.unpack_2bit(z["packed"], n)
    nm = np.unpackbits(z["n_mask"])[:n].astype(bool)
    codes[nm] = BASE_N
    genome = Genome(codes, [str(x) for x in z["names"]],
                    z["starts"], z["lengths"])
    kind = str(z["kind"]) if "kind" in z else "csr"
    if kind == "fm":
        index = FmIndex(int(z["mer_size"]), z["sa"], z["bwt_words"],
                        z["occ"], z["c_table"])
    elif kind == "fm_bs":
        m = int(z["mer_size"])
        index = FmBsPair(
            FmIndex(m, z["sa"], z["bwt_words"], z["occ"], z["c_table"]),
            FmIndex(m, z["sa_minus"], z["bwt_words_minus"],
                    z["occ_minus"], z["c_table_minus"]))
    elif kind == "csr_bs":
        m = int(z["mer_size"])
        index = BsIndexPair(
            CsrIndex(m, z["bucket_start"], z["positions"]),
            CsrIndex(m, z["bucket_start_minus"], z["positions_minus"]))
    else:
        index = CsrIndex(int(z["mer_size"]), z["bucket_start"],
                         z["positions"])
    return genome, index


def shard_index(index: CsrIndex, n_shards: int) -> List[CsrIndex]:
    """Split the CSR table by k-mer-code range into n_shards bucket ranges
    (the mesh axis "index" layout, SURVEY.md §2 TP row).

    Shard s owns k-mer codes [s*Q, (s+1)*Q) with Q = ceil(nb / n_shards);
    a query is routed to shard ``kmer // Q`` (static integer divide on
    device — no hashing).  Every shard's bucket array is padded to the
    uniform Q+1 length (trailing empty buckets) so shards stack into one
    device-sharded array; non-divisible bucket counts (the base-3
    bisulfite tables, 3^m) just leave the last shard partly empty.
    """
    nb = index.n_buckets
    Q = -(-nb // n_shards)
    shards = []
    for s in range(n_shards):
        lo_b, hi_b = min(s * Q, nb), min((s + 1) * Q, nb)
        lo, hi = index.bucket_start[lo_b], index.bucket_start[hi_b]
        bs = np.full(Q + 1, int(hi) - int(lo), dtype=np.int32)
        bs[:hi_b - lo_b + 1] = (
            index.bucket_start[lo_b:hi_b + 1].astype(np.int64)
            - int(lo)).astype(np.int32)
        shards.append(CsrIndex(index.mer_size, bs,
                               index.positions[lo:hi].copy()))
    return shards
