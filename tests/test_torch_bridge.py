"""Where the two packages meet in the tests: a value of the JAX package
(``gnumap_tpu``) is rebuilt as the same class of the port
(``gnumap_tpu_torch``) from its fields.  Only numpy arrays and plain values
cross; the port never sees an object of the JAX package."""

import dataclasses
import importlib


def to_port(obj):
    """``obj`` with every ``gnumap_tpu`` dataclass in it (MapperConfig,
    Genome, CsrIndex, BsIndexPair, ReadRecord, ReadBatch, ...) replaced by
    the class of the same module and name in ``gnumap_tpu_torch``; lists,
    tuples and iterators of such values are rebuilt element by element."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        if mod.startswith("gnumap_tpu."):
            cls = getattr(importlib.import_module(
                "gnumap_tpu_torch." + mod[len("gnumap_tpu."):]),
                type(obj).__name__)
            return cls(**{f.name: to_port(getattr(obj, f.name))
                          for f in dataclasses.fields(obj) if f.init})
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(x) for x in obj)
    return obj


def port_iter(it):
    """A lazy iterator of ``to_port`` values (for batch streams)."""
    return (to_port(x) for x in it)


def test_to_port_rebuilds_by_fields():
    """A MapperConfig, a genome with its indexes (the bisulfite CSR pair,
    the FM index and its bisulfite pair) and a read batch cross as their
    fields: equal values, the port's classes, shared arrays."""
    import numpy as np
    from gnumap_tpu import config as jconfig
    from gnumap_tpu.index import builder as jbuilder
    from gnumap_tpu.io import fastq as jfastq
    from gnumap_tpu_torch import config as tconfig
    from gnumap_tpu_torch.index import builder as tbuilder
    from gnumap_tpu_torch.io import fastq as tfastq
    jc = jconfig.MapperConfig(mer_size=6, gap_slack=3, bisulfite=True,
                              subst_matrix=((1.0, 0.0, 0.0, 0.0),) * 4)
    tc = to_port(jc)
    assert type(tc) is tconfig.MapperConfig
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.band() == jc.band()
    jg = jbuilder.Genome.from_contigs([("a", "ACGTTGCA" * 20)])
    ji = jbuilder.build_bs_index(jg, jc)
    tg, ti = to_port((jg, ji))
    assert type(tg) is tbuilder.Genome and tg.codes is jg.codes
    assert type(ti) is tbuilder.BsIndexPair
    assert type(ti.plus) is tbuilder.CsrIndex
    assert np.array_equal(ti.minus.positions, ji.minus.positions)
    from gnumap_tpu.index import fm as jfm
    from gnumap_tpu_torch.index import fm as tfm
    jf = jfm.build_bs_fm_index(jg, jc)
    tf, tf1 = to_port((jf, jf.plus))
    assert type(tf) is tfm.FmBsPair and type(tf1) is tfm.FmIndex
    assert type(tf.minus) is tfm.FmIndex and tf.mer_size == 6
    assert tf1.sa is jf.plus.sa and tf1.n == jf.plus.n
    assert np.array_equal(tf.minus.occ, jf.minus.occ)
    rec = jfastq.ReadRecord("r", jg.codes[:8], None,
                            np.full(8, 30, np.int16))
    batches = list(port_iter(jfastq.batch_reads(iter([rec]), jc)))
    assert type(batches[0]) is tfastq.ReadBatch and batches[0].n == 1
    assert to_port([1, "x", None, (2.5,)]) == [1, "x", None, (2.5,)]
