"""The bank's host build against the JAX package's, array for array.

The port reads each ``.h3m`` record's core model as one block, configures
a whole library in one pass over the node index (``configure_many``) and
writes each bank tensor with one scatter; the JAX package's
``read_h3m``, ``configure_local`` and ``ProfileBank.build``, which work
node by node and profile by profile, are the reference, and every array
has to equal theirs bit for bit: a 64-profile Pfam-shaped bank written
by ``write_h3m``, records that set every optional field (in formats 3/c
and 3/f, and byte-swapped), profiles of 1 to 2,200 nodes in one batch.
Last, the annotator counts the profiles each reader gave.
"""

import io
import math
import struct

import numpy
import pytest

from gecco_tpu.hmm import batch as jax_batch
from gecco_tpu.hmm.h3m import read_h3m as jax_read_h3m
from gecco_tpu.hmm.io import ProfileHMM as JaxProfileHMM
from gecco_tpu.hmm.profile import configure_local as jax_configure_local
from gecco_tpu.hmm.profile import match_occupancy as jax_match_occupancy
from gecco_tpu.hmm.synthetic import pfam_shaped_profiles

from gecco_tpu_torch.hmm import HMM, ProfileHMMAnnotator
from gecco_tpu_torch.hmm.bank import ProfileBank
from gecco_tpu_torch.hmm.h3m import H3M_MAGICS, read_h3m, write_h3m
from gecco_tpu_torch.hmm.io import AMINO_ALPHABET, ProfileHMM
from gecco_tpu_torch.hmm.profile import configure_local, configure_many, match_occupancy
from gecco_tpu_torch.hmm.synthetic import synthetic_profiles
from gecco_tpu_torch.model import Gene, Protein, Strand
from gecco_tpu_torch.profiling import TIMER
from gecco_tpu_torch.seq import Seq, SeqRecord

PROFILE_ARRAYS = ("msc", "tmm", "tim", "tdm", "tmi", "tii", "tmd", "tdd", "bm")
#: fields of a read profile besides its arrays
METADATA = ("name", "accession", "description", "length", "alphabet", "stats", "cutoffs",
            "map_annotation", "consensus")
#: every optional flag of a record (``p7_hmm.h``): DESC, RF, CS, STATS, MAP,
#: ACC, GA, TC, NC, CA, COMPO, CHKSUM, CONS, MMASK
EVERY_FLAG = sum(1 << bit for bit in (1, 2, 3, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17))


def _fields(hmm):
    return {
        "name": hmm.name, "accession": hmm.accession, "description": hmm.description,
        "length": hmm.length, "alphabet": "amino", "match": hmm.match.copy(),
        "insert": hmm.insert.copy(), "trans": hmm.trans.copy(), "compo": hmm.compo,
        "stats": dict(hmm.stats), "cutoffs": dict(hmm.cutoffs),
        "map_annotation": hmm.map_annotation, "consensus": hmm.consensus,
    }


def _pair(fields):
    """The same profile as the port's and as the JAX package's object."""
    return ProfileHMM(**fields), JaxProfileHMM(**_fields(ProfileHMM(**fields)))


def _odd_lengths(lengths, seed):
    """Profiles of the given lengths, with zero transitions and emissions
    (``-inf`` after the log) and some without calibration."""
    rng = numpy.random.default_rng(seed)
    out = []
    for p, M in enumerate(lengths):
        trans = numpy.zeros((M + 1, 7))
        trans[:, 0:3] = rng.dirichlet([50.0, 1.0, 1.0], size=M + 1)
        trans[:, 3:5] = rng.dirichlet([1.0, 1.0], size=M + 1)
        trans[:, 5:7] = rng.dirichlet([1.0, 1.0], size=M + 1)
        trans[M] = [1.0, 0.0, 0.0, 0.5, 0.5, 1.0, 0.0]
        match = rng.dirichlet(numpy.full(20, 0.05), size=M + 1)
        match[0] = 0.0
        stats = {} if p % 3 == 2 else {
            "MSV": (-8.5 + 0.1 * p, 0.69), "VITERBI": (-9.25, 0.71), "FORWARD": (-4.75, 0.7)}
        out.append(dict(
            name=f"ODD{p}", accession=None if p == 1 else f"PF{p:05d}.1", description=None,
            length=M, alphabet="amino", match=match,
            insert=rng.dirichlet(numpy.ones(20), size=M + 1), trans=trans, stats=stats,
        ))
    return out


@pytest.fixture(scope="module")
def bank_fields():
    """The fields of a 64-profile Pfam-shaped bank, a few with COMPO,
    consensus, map, cutoffs or no calibration."""
    fields = [_fields(gm.hmm) for gm in pfam_shaped_profiles(64, seed=5)]
    for f in fields:
        f["match"][0] = 0.0
    M = fields[0]["length"]
    fields[0].update(compo=fields[0]["match"][1:].mean(axis=0), description="first",
                     consensus="".join(AMINO_ALPHABET[a] for a in fields[0]["match"][1:].argmax(1)),
                     map_annotation=list(range(3, M + 3)))
    fields[1]["cutoffs"] = {"GA": (21.5, 20.0), "TC": (22.25, 21.0), "NC": (19.5, 18.75)}
    fields[2]["stats"] = {}
    return fields


def _record(f, end, magic):
    """A record of ``f`` with every optional field, in byte order ``end``
    (``<`` or ``>``) and format ``magic`` (MMASK only in 3/f, max_length
    from 3/c)."""
    M = f["length"]
    match = f["match"][1:]
    stats = f.get("stats") or {"MSV": (-7.5, 0.7), "VITERBI": (-8.5, 0.7), "FORWARD": (-4.5, 0.7)}
    cutoffs = f.get("cutoffs") or {"GA": (25.0, 24.0), "TC": (26.0, 25.0), "NC": (23.0, 22.0)}
    consensus = f.get("consensus") or "".join(AMINO_ALPHABET[a] for a in match.argmax(1))
    mapping = f.get("map_annotation") or list(range(1, M + 1))

    def string(text):
        raw = text.encode() + b"\0"
        return struct.pack(end + "i", len(raw)) + raw

    def row(text):
        return b" " + text.encode() + b"\0"

    def f32(values):
        return numpy.asarray(values, dtype=end + "f4").tobytes()

    out = [struct.pack(end + "Iiii", magic, EVERY_FLAG, M, 3), string(f["name"]),
           string(f["accession"] or "PF99999.1"), string(f["description"] or "a profile"),
           row("x" * M)]                                        # RF
    if magic == H3M_MAGICS[5]:
        out.append(row("m" * M))                                # model mask
    out += [row(consensus), row("H" * M), row("9" * M)]         # CONS, CS, CA
    out += [string("hmmbuild x.hmm x.sto"), struct.pack(end + "if", 12, 3.5)]
    if magic in H3M_MAGICS[2:]:
        out.append(struct.pack(end + "i", 400))                 # max_length
    out += [string("Mon Jan  1 00:00:00 2024"),
            numpy.asarray([0, *mapping], dtype=end + "i4").tobytes(),
            struct.pack(end + "I", 0xDEADBEEF),
            f32([*stats["MSV"], *stats["VITERBI"], *stats["FORWARD"]]),
            f32([*cutoffs["GA"], *cutoffs["TC"], *cutoffs["NC"]]),
            f32(match.mean(axis=0) if f.get("compo") is None else f["compo"]),
            f32(f["trans"]), f32(match), f32(f["insert"])]
    return b"".join(out)


def _library(fields, source):
    if source == "write_h3m":
        target = io.BytesIO()
        write_h3m(target, [ProfileHMM(**f) for f in fields])
        return target.getvalue()
    end, magic = {"every_flag": ("<", H3M_MAGICS[5]), "every_flag_3c": ("<", H3M_MAGICS[2]),
                  "byteswapped": (">", H3M_MAGICS[5])}[source]
    return b"".join(_record(f, end, magic) for f in fields)


def _f32(a):
    return numpy.asarray(a, dtype=numpy.float32).astype(numpy.float64)


@pytest.mark.parametrize("source", ["write_h3m", "every_flag", "every_flag_3c", "byteswapped"])
def test_read_h3m_equals_jax(bank_fields, source):
    fields = bank_fields + _odd_lengths([1, 2, 900], seed=8)
    data = _library(fields, source)
    mine, theirs = list(read_h3m(data)), list(jax_read_h3m(data))
    assert len(mine) == len(theirs) == len(fields)
    for a, b, f in zip(mine, theirs, fields):
        for key in METADATA:
            assert getattr(a, key) == getattr(b, key), key
        for key in ("trans", "match", "insert", "compo"):
            x, y = getattr(a, key), getattr(b, key)
            if x is None or y is None:       # no COMPO
                assert x is None and y is None and source == "write_h3m", key
                continue
            assert x.dtype == y.dtype == numpy.float64 and x.shape == y.shape, key
            numpy.testing.assert_array_equal(x, y)
        # and the values written, whatever the byte order
        for key in ("trans", "match", "insert"):
            numpy.testing.assert_array_equal(getattr(a, key), _f32(f[key]))
        assert not a.match[0].any()
        if source != "write_h3m":
            assert a.description == (f["description"] or "a profile")
            assert set(a.stats) == {"MSV", "VITERBI", "FORWARD"}
            assert set(a.cutoffs) == {"GA", "TC", "NC"} and len(a.consensus) == a.length


@pytest.mark.parametrize("where", ["trans", "match", "insert", "last_byte", "second_record"])
def test_read_h3m_truncated_core(where):
    (one,) = _odd_lengths([6], seed=2)
    record = _library([one], "write_h3m")
    M = one["length"]
    core = len(record) - 4 * (7 * (M + 1) + 20 * M + 20 * (M + 1))
    cut = {"trans": core + 5, "match": core + 4 * 7 * (M + 1) + 9,
           "insert": len(record) - 4 * 20 * (M + 1) + 2, "last_byte": len(record) - 1,
           "second_record": 2 * len(record) - 30}[where]
    data = (record + record)[:cut]
    for reader in (read_h3m, jax_read_h3m):
        with pytest.raises(ValueError, match="truncated .h3m file"):
            list(reader(data))


def _assert_profiles_equal(a, b):
    assert (a.M, a.loop_e, a.move_e) == (b.M, b.loop_e, b.move_e)
    for key in PROFILE_ARRAYS:
        x, y = getattr(a, key), getattr(b, key)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        numpy.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("multihit", [True, False])
def test_configure_many_equals_jax(bank_fields, multihit):
    """One batch of 1 to 2,200 nodes (and the bank), each profile as JAX's
    ``configure_local`` configures it alone."""
    pairs = [_pair(f) for f in _odd_lengths([1, 2200, 2, 37, 1273, 3], seed=11) + bank_fields]
    mine = configure_many([p for p, _ in pairs], multihit=multihit)
    assert len(mine) == len(pairs)
    for a, (hmm, jax_hmm) in zip(mine, pairs):
        assert a.hmm is hmm
        _assert_profiles_equal(a, jax_configure_local(jax_hmm, multihit=multihit))
    assert configure_many([]) == []


@pytest.mark.parametrize("M", [1, 2, 37, 1500])
def test_configure_batch_of_one_equals_jax(M):
    ((hmm, jax_hmm),) = [_pair(f) for f in _odd_lengths([M], seed=M)]
    theirs = jax_configure_local(jax_hmm)
    _assert_profiles_equal(configure_many([hmm])[0], theirs)
    _assert_profiles_equal(configure_local(hmm), theirs)
    numpy.testing.assert_array_equal(match_occupancy(hmm), jax_match_occupancy(jax_hmm))


@pytest.mark.parametrize("lane", [128, 32])
def test_bank_build_equals_jax(bank_fields, lane):
    pairs = [_pair(f) for f in bank_fields + _odd_lengths([1, 700, 5, 2], seed=4)]
    with pytest.warns(UserWarning, match="lack STATS"):
        mine = ProfileBank.build(configure_many([p for p, _ in pairs]), lane=lane)
    with pytest.warns(UserWarning, match="lack STATS"):
        theirs = jax_batch.ProfileBank.build([jax_configure_local(j) for _, j in pairs], lane=lane)
    widest = max(hmm.length for hmm, _ in pairs)
    assert (mine.P, mine.Mp) == (theirs.P, theirs.Mp)
    assert (mine.P, mine.Mp) == (len(pairs), math.ceil(widest / lane) * lane)
    for key, value in vars(mine).items():
        other = getattr(theirs, key)
        if isinstance(value, list):
            assert value == other, key
        else:
            assert value.dtype == other.dtype and value.shape == other.shape, key
            numpy.testing.assert_array_equal(value, other)


def _write_text(path, hmms):
    """An ASCII HMMER3 file of ``hmms`` (values as ``-ln p``)."""

    def values(ps):
        return "  ".join("*" if p <= 0 else f"{-math.log(p):.5f}" for p in ps)

    lines = ["HMMER3/f [3.1b2 | February 2015]"]
    for h in hmms:
        lines += [f"NAME  {h.name}", f"ACC   {h.accession}", f"LENG  {h.length}", "ALPH  amino"]
        lines += [f"STATS LOCAL {key} {a} {b}" for key, (a, b) in h.stats.items()]
        lines += ["HMM          " + "        ".join(AMINO_ALPHABET),
                  "            m->m     m->i     m->d     i->m     i->i     d->m     d->d",
                  "         " + values(h.insert[0]), "         " + values(h.trans[0])]
        for k in range(1, h.length + 1):
            lines += [f"    {k}   " + values(h.match[k]), "         " + values(h.insert[k]),
                      "         " + values(h.trans[k])]
        lines.append("//")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("reader", ["h3m", "text"])
def test_annotator_counts_the_profiles_each_reader_gave(tmp_path, reader):
    profiles = synthetic_profiles(6, min_length=40, max_length=80, seed=17)
    path = str(tmp_path / ("bank.h3m" if reader == "h3m" else "bank.hmm"))
    if reader == "h3m":
        write_h3m(path, [gm.hmm for gm in profiles])
    else:
        _write_text(path, [gm.hmm for gm in profiles])
    rng = numpy.random.default_rng(3)
    record = SeqRecord(id="contig", seq=Seq("A" * 10))
    proteins = ["".join(AMINO_ALPHABET[c] for c in rng.integers(0, 20, 120)) for _ in range(4)]
    genes = [
        Gene(record, 1 + 3000 * i, 3000 * (i + 1), Strand.Coding, Protein(f"contig_{i + 1}", Seq(x)))
        for i, x in enumerate(proteins)
    ]
    TIMER.reset()
    ProfileHMMAnnotator(HMM("Pfam", "0", "", path, size=6), device="cpu").run(genes)
    counters = TIMER.export()["counters"]
    other = "text" if reader == "h3m" else "h3m"
    assert counters[f"read_profiles.{reader}"] == len(profiles)
    assert f"read_profiles.{other}" not in counters
