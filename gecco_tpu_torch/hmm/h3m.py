"""Binary HMMER3 ``.h3m`` (pressed core-model) reader and writer.

The reference ships its pruned Pfam library as a pressed binary
``.h3m`` built at package-build time (``setup.py:344-372``
via ``pyhmmer.plan7.HMMFile`` + binary write), so a user pointing this
package at a reference-built data directory hands us ``.h3m`` input.
This module parses that format directly (and writes it, for the
round-trip tests and for producing reference-layout data directories).

Layout (HMMER ``p7_hmmfile_WriteBinary``, format 3/f; every record):

* ``uint32`` magic — ``b"hmm5".."hmm:" + 0x80808080`` for formats
  3/a..3/f, native byte order (a byteswapped magic is honoured too);
* ``int32`` flags, ``int32`` M, ``int32`` alphabet type (3 = amino);
* name / [accession] / [description] as length-prefixed strings (the
  ``int32`` length INCLUDES the trailing NUL);
* optional per-flag annotation lines, each ``M+2`` raw chars:
  RF, model mask (3/f only), consensus, CS, CA;
* command log string, ``int32`` nseq, ``float32`` eff_nseq,
  ``int32`` max_length (3/c+ only), ctime string;
* optional alignment map: ``int32 × (M+1)``;
* ``uint32`` checksum;
* ``float32 × 6`` E-value params (MSV mu/lambda, Viterbi mu/lambda,
  Forward tau/lambda; −99999 = unset);
* ``float32 × 6`` Pfam cutoffs (GA1 GA2 TC1 TC2 NC1 NC2);
* optional COMPO: ``float32 × 20``;
* the core model in PROBABILITY space (unlike the −ln p ASCII form):
  transitions ``t[0..M][7]`` (MM MI MD IM II DM DD), match emissions
  ``mat[1..M][20]``, insert emissions ``ins[0..M][20]``.

``.h3f``/``.h3p``/``.h3i`` (the vectorized filter/profile halves and the
SSI index, different magics) are NOT model containers and are rejected
with a pointer at the ``.h3m``.
"""

import struct
from typing import BinaryIO, Iterator, List, Optional, Sequence, Tuple, Union

import numpy

from .._meta import zopen
from .io import AMINO_ALPHABET, ProfileHMM

__all__ = ["H3M_MAGICS", "is_h3m", "read_h3m", "write_h3m"]

#: Record magics of binary core-model files, formats 3/a .. 3/f
#: (``"hmm5".."hmm:"`` with the high bit set on every byte).
H3M_MAGICS = tuple(0xE8EDEDB5 + i for i in range(6))
_V3F_MAGIC = H3M_MAGICS[5]
_V3C_PLUS = frozenset(H3M_MAGICS[2:])   # formats with max_length

#: Magics of the pressed auxiliary files (``p7_oprofile`` halves):
#: ``.h3f`` (MSV filter part) and ``.h3p`` (remaining profile part).
_AUX_MAGICS = frozenset((0xB8B3E6F6, 0xE8B3E6F3, 0xE8B3E6F4, 0xB8B3E4F3))

# p7_hmm.h flags consumed here
_F_DESC = 1 << 1
_F_RF = 1 << 2
_F_CS = 1 << 3
_F_STATS = 1 << 7
_F_MAP = 1 << 8
_F_ACC = 1 << 9
_F_GA = 1 << 10
_F_TC = 1 << 11
_F_NC = 1 << 12
_F_CA = 1 << 13
_F_COMPO = 1 << 14
_F_CHKSUM = 1 << 15
_F_CONS = 1 << 16
_F_MMASK = 1 << 17

_EVPARAM_UNSET = -99999.0
_K = len(AMINO_ALPHABET)


class _Reader:
    """Cursor over the raw bytes with byte-order awareness."""

    def __init__(self, data: bytes, swap: bool):
        self.data = data
        self.pos = 0
        self.end = "<" if (numpy.little_endian ^ swap) else ">"

    def skip(self, n: int) -> int:
        """Step over ``n`` bytes; returns their offset."""
        if self.pos + n > len(self.data):
            raise ValueError("truncated .h3m file")
        self.pos += n
        return self.pos - n

    def take(self, n: int) -> bytes:
        at = self.skip(n)
        return self.data[at : at + n]

    def u32(self) -> int:
        return struct.unpack_from(self.end + "I", self.data, self.skip(4))[0]

    def i32(self) -> int:
        return struct.unpack_from(self.end + "i", self.data, self.skip(4))[0]

    def f32(self, n: int = 1) -> "numpy.ndarray":
        return self.f32_block(n).astype(numpy.float64)

    def f32_block(self, n: int) -> "numpy.ndarray":
        """``n`` float32 values as a read-only view of the file's bytes."""
        dt = numpy.dtype(numpy.float32).newbyteorder(self.end)
        return numpy.frombuffer(self.data, dtype=dt, count=n, offset=self.skip(4 * n))

    def i32v(self, n: int) -> "numpy.ndarray":
        dt = numpy.dtype(numpy.int32).newbyteorder(self.end)
        return numpy.frombuffer(self.take(4 * n), dtype=dt)

    def string(self) -> Optional[str]:
        n = self.i32()
        if n == 0:
            return None
        raw = self.take(n)
        return raw[:-1].decode("ascii", "replace")  # length includes NUL

    def annotation(self, m: int) -> str:
        """An M+2 char annotation row: [0] pad, [1..M] chars, [M+1] NUL."""
        raw = self.take(m + 2)
        return raw[1 : m + 1].decode("ascii", "replace")


def is_h3m(raw: bytes) -> bool:
    """True if ``raw`` begins with a binary core-model record magic."""
    if len(raw) < 4:
        return False
    le, be = struct.unpack("<I", raw[:4])[0], struct.unpack(">I", raw[:4])[0]
    return le in H3M_MAGICS or be in H3M_MAGICS


def read_h3m(source: Union[str, bytes, BinaryIO]) -> Iterator[ProfileHMM]:
    """Parse every profile of a pressed binary ``.h3m`` file."""
    if isinstance(source, bytes):
        data = source
    else:
        with zopen(source) as handle:
            data = handle.read()
    if len(data) < 4:
        raise ValueError("not a .h3m file (too short)")
    le = struct.unpack("<I", data[:4])[0]
    be = struct.unpack(">I", data[:4])[0]
    if le in _AUX_MAGICS or be in _AUX_MAGICS:
        raise ValueError(
            "this is a pressed .h3f/.h3p auxiliary file, not a model "
            "container — load the .h3m next to it"
        )
    if le in H3M_MAGICS:
        swap = not numpy.little_endian
    elif be in H3M_MAGICS:
        swap = bool(numpy.little_endian)
    else:
        raise ValueError("not a binary HMMER3 .h3m file (bad magic)")

    r = _Reader(data, swap)
    while r.pos < len(data):
        magic = r.u32()
        if magic not in H3M_MAGICS:
            raise ValueError(f"bad record magic 0x{magic:08x} in .h3m")
        yield _read_record(r, magic)


def _read_record(r: _Reader, magic: int) -> ProfileHMM:
    flags = r.i32()
    M = r.i32()
    alphatype = r.i32()
    if alphatype != 3:
        raise ValueError(
            f"unsupported .h3m alphabet type {alphatype} (only amino = 3)"
        )
    name = r.string() or "-"
    accession = r.string() if flags & _F_ACC else None
    description = r.string() if flags & _F_DESC else None
    if flags & _F_RF:
        r.annotation(M)
    if magic == _V3F_MAGIC and flags & _F_MMASK:
        r.annotation(M)
    consensus = r.annotation(M) if flags & _F_CONS else None
    if flags & _F_CS:
        r.annotation(M)
    if flags & _F_CA:
        r.annotation(M)
    r.string()                      # command log
    r.i32()                         # nseq
    r.f32()                         # eff_nseq
    if magic in _V3C_PLUS:
        r.i32()                     # max_length
    r.string()                      # ctime
    map_annotation: Optional[List[int]] = None
    if flags & _F_MAP:
        map_annotation = [int(v) for v in r.i32v(M + 1)[1:]]
    r.u32()                         # checksum
    evparam = r.f32(6)
    cutoff = r.f32(6)
    compo = r.f32(_K) if flags & _F_COMPO else None

    # the core model is one contiguous float32 block: t[0..M][7],
    # mat[1..M][20], ins[0..M][20]; it is widened once into a float64
    # block that leaves room for match row 0 (zeros), so that trans,
    # match and insert are views of it
    nt, nk = (M + 1) * 7, (M + 1) * _K
    core = r.f32_block(nt + M * _K + nk)
    block = numpy.empty(nt + 2 * nk, dtype=numpy.float64)
    block[:nt] = core[:nt]
    block[nt : nt + _K] = 0.0
    block[nt + _K :] = core[nt:]
    trans = block[:nt].reshape(M + 1, 7)
    match = block[nt : nt + nk].reshape(M + 1, _K)
    insert = block[nt + nk :].reshape(M + 1, _K)

    stats = {}
    if flags & _F_STATS and evparam[0] > _EVPARAM_UNSET:
        stats["MSV"] = (float(evparam[0]), float(evparam[1]))
        stats["VITERBI"] = (float(evparam[2]), float(evparam[3]))
        stats["FORWARD"] = (float(evparam[4]), float(evparam[5]))
    cutoffs = {}
    if flags & _F_GA:
        cutoffs["GA"] = (float(cutoff[0]), float(cutoff[1]))
    if flags & _F_TC:
        cutoffs["TC"] = (float(cutoff[2]), float(cutoff[3]))
    if flags & _F_NC:
        cutoffs["NC"] = (float(cutoff[4]), float(cutoff[5]))

    return ProfileHMM(
        name=name,
        accession=accession,
        description=description,
        length=M,
        alphabet="amino",
        match=match,
        insert=insert,
        trans=trans,
        compo=compo,
        stats=stats,
        cutoffs=cutoffs,
        map_annotation=map_annotation,
        consensus=consensus,
    )


def _bin_string(value: Optional[str]) -> bytes:
    if value is None:
        return struct.pack("<i", 0)
    raw = value.encode("ascii", "replace") + b"\0"
    return struct.pack("<i", len(raw)) + raw


def write_h3m(
    target: Union[str, BinaryIO], profiles: Sequence[ProfileHMM]
) -> None:
    """Write profiles as a binary 3/f ``.h3m`` (native little-endian)."""
    chunks: List[bytes] = []
    for gm in profiles:
        chunks.append(_record_bytes(gm))
    payload = b"".join(chunks)
    if isinstance(target, str):
        with open(target, "wb") as handle:
            handle.write(payload)
    else:
        target.write(payload)


def _record_bytes(gm: ProfileHMM) -> bytes:
    M = gm.length
    flags = 0
    if gm.accession is not None:
        flags |= _F_ACC
    if gm.description is not None:
        flags |= _F_DESC
    if gm.consensus is not None and len(gm.consensus) == M:
        flags |= _F_CONS
    if gm.map_annotation is not None and len(gm.map_annotation) == M:
        flags |= _F_MAP
    if gm.compo is not None:
        flags |= _F_COMPO
    if all(k in gm.stats for k in ("MSV", "VITERBI", "FORWARD")):
        flags |= _F_STATS
    for key, bit in (("GA", _F_GA), ("TC", _F_TC), ("NC", _F_NC)):
        if key in gm.cutoffs:
            flags |= bit

    out: List[bytes] = [struct.pack("<Iiii", _V3F_MAGIC, flags, M, 3)]
    out.append(_bin_string(gm.name))
    if flags & _F_ACC:
        out.append(_bin_string(gm.accession))
    if flags & _F_DESC:
        out.append(_bin_string(gm.description))
    if flags & _F_CONS:
        out.append(b" " + gm.consensus.encode("ascii", "replace") + b"\0")
    out.append(_bin_string(None))   # command log
    out.append(struct.pack("<if", 0, 0.0))  # nseq, eff_nseq
    out.append(struct.pack("<i", 0))        # max_length (3/c+)
    out.append(_bin_string(None))   # ctime
    if flags & _F_MAP:
        arr = numpy.zeros(M + 1, dtype=numpy.int32)
        arr[1:] = gm.map_annotation
        out.append(arr.astype("<i4").tobytes())
    out.append(struct.pack("<I", 0))        # checksum
    ev = numpy.full(6, _EVPARAM_UNSET, dtype=numpy.float32)
    if flags & _F_STATS:
        ev[0:2] = gm.stats["MSV"]
        ev[2:4] = gm.stats["VITERBI"]
        ev[4:6] = gm.stats["FORWARD"]
    out.append(ev.astype("<f4").tobytes())
    cut = numpy.full(6, _EVPARAM_UNSET, dtype=numpy.float32)
    for key, base in (("GA", 0), ("TC", 2), ("NC", 4)):
        if key in gm.cutoffs:
            cut[base : base + 2] = gm.cutoffs[key]
    out.append(cut.astype("<f4").tobytes())
    if flags & _F_COMPO:
        out.append(numpy.asarray(gm.compo, dtype="<f4").tobytes())
    out.append(numpy.asarray(gm.trans, dtype="<f4").tobytes())
    out.append(numpy.asarray(gm.match[1:], dtype="<f4").tobytes())
    out.append(numpy.asarray(gm.insert, dtype="<f4").tobytes())
    return b"".join(out)
