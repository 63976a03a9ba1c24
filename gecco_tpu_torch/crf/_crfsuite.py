"""Readers for CRFsuite binary artifacts (model import compatibility).

Lets ``ClusterCRF.trained`` consume a model directory produced by the
*reference* ``gecco train`` (a ``model.pkl`` pickling a
``sklearn_crfsuite.CRF`` with an embedded CRFsuite "lCRF" binary blob)
without any of those libraries installed: the pickle is walked with stub
classes and the lCRF container (features + CQDB string tables) is parsed
directly.  Format knowledge from the CRFsuite on-disk layout
(``crf1d_model.c`` / ``cqdb.c``); referenced by
``gecco/crf/__init__.py:61-99`` (model load path).
"""

import pickle
import struct
from typing import Dict, List, Tuple

import numpy

__all__ = ["load_reference_pickle", "parse_lcrf", "parse_cqdb"]

FT_STATE = 0
FT_TRANS = 1


class _Stub:
    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins":
            import builtins

            return getattr(builtins, name)
        return type(name, (_Stub,), {"_module": module})


def _state(obj) -> dict:
    return obj.__dict__.get("_state", obj.__dict__)


def parse_cqdb(blob: bytes, offset: int) -> List[str]:
    """Decode a CRFsuite constant-quark-database chunk into an id→string list."""
    magic, _size, _flag, _bo, bwd_size, bwd_offset = struct.unpack_from("<4s5I", blob, offset)
    if magic != b"CQDB":
        raise ValueError(f"bad CQDB magic at {offset}: {magic!r}")
    names: Dict[int, str] = {}
    positions = struct.unpack_from(f"<{bwd_size}I", blob, offset + bwd_offset)
    for pos in positions:
        rec_id, key_size = struct.unpack_from("<2I", blob, offset + pos)
        key = blob[offset + pos + 8 : offset + pos + 8 + key_size]
        names[rec_id] = key.rstrip(b"\x00").decode()
    return [names[i] for i in range(len(names))]


def parse_lcrf(blob: bytes) -> Tuple[List[str], List[str], "numpy.ndarray", "numpy.ndarray"]:
    """Parse an lCRF model blob → (labels, attrs, state [A,L], trans [L,L])."""
    (magic, _size, model_type, _version,
     _num_features, num_labels, num_attrs,
     off_features, off_labels, off_attrs,
     _off_labelrefs, _off_attrrefs) = struct.unpack_from("<4sI4s9I", blob, 0)
    if magic != b"lCRF" or model_type != b"FOMC":
        raise ValueError(f"not a first-order CRFsuite model: {magic!r}/{model_type!r}")
    labels = parse_cqdb(blob, off_labels)
    attrs = parse_cqdb(blob, off_attrs)
    feat_magic, _chunk_size, num = struct.unpack_from("<4s2I", blob, off_features)
    if feat_magic != b"FEAT":
        raise ValueError(f"bad FEAT magic: {feat_magic!r}")
    state = numpy.zeros((num_attrs, num_labels), dtype=numpy.float64)
    trans = numpy.zeros((num_labels, num_labels), dtype=numpy.float64)
    pos = off_features + 12
    for _ in range(num):
        ftype, src, dst = struct.unpack_from("<3I", blob, pos)
        (weight,) = struct.unpack_from("<d", blob, pos + 12)
        pos += 20
        if ftype == FT_STATE:
            state[src, dst] = weight
        elif ftype == FT_TRANS:
            trans[src, dst] = weight
        else:
            raise ValueError(f"unknown feature type {ftype}")
    return labels, attrs, state, trans


def load_reference_pickle(path) -> dict:
    """Load a reference ``model.pkl`` into plain arrays + metadata."""
    with open(path, "rb") as f:
        obj = _StubUnpickler(f).load()
    top = _state(obj)
    crf = _state(top["model"])
    blob = _state(crf["modelfile"])["__FILE_RESOURCE_DATA__"]
    labels, attrs, state, trans = parse_lcrf(blob)
    return {
        "attr_names": attrs,
        "label_names": labels,
        "state": state,
        "trans": trans,
        "significance": top.get("significance") or {},
        "feature_type": top["feature_type"],
        "window_size": int(top["window_size"]),
        "window_step": int(top["window_step"]),
        "algorithm": top.get("algorithm", "lbfgs"),
        "c1": float(crf.get("c1") or 0.0),
        "c2": float(crf.get("c2") or 0.0),
    }
