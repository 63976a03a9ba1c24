"""Typed TSV tables with schema-aware load/dump.

Re-implements the behavior of the reference's polars-backed ``Table``
base class (``gecco/_base.py:64-151``) on plain Python
columns:

* tab-separated dump with a header row;
* float cells rendered with shortest round-trip ``repr`` (what polars'
  ``write_csv`` produces), ``NaN`` rendered as an empty cell;
* on load, empty float cells become ``NaN``;
* on dump, columns whose every value equals the column default are
  elided (``_base.py:133-151``), except for subclasses that opt out.
"""

import abc
import io
import math
import os
from typing import BinaryIO, Dict, Iterator, List, NamedTuple, Optional, Sequence, Type, TypeVar, Union

__all__ = ["Column", "Table"]

_T = TypeVar("_T", bound="Table")


class Column(NamedTuple):
    name: str
    dtype: type  # str, int or float
    default: Optional[object] = None


def _format_cell(value: object, dtype: type) -> str:
    if dtype is float:
        fvalue = float(value)  # type: ignore[arg-type]
        if math.isnan(fvalue):
            return ""
        return repr(fvalue)
    if value is None:
        return ""
    return str(value)


def _parse_cell(text: str, dtype: type) -> object:
    if dtype is float:
        return math.nan if text == "" else float(text)
    if dtype is int:
        return int(text)
    return text


class Table(abc.ABC):
    """A column-typed table serializable to/from TSV."""

    #: When `True`, `dump` keeps every column even if all-default.
    _KEEP_ALL_COLUMNS = False

    @classmethod
    @abc.abstractmethod
    def _get_columns(cls) -> List[Column]:
        raise NotImplementedError

    def __init__(self, data: Optional[Dict[str, list]] = None) -> None:
        columns = self._get_columns()
        self._schema = {c.name: c for c in columns}
        self._extra_columns: List[Column] = []
        self._data: Dict[str, list] = {}
        data = data or {}
        length = max((len(v) for v in data.values()), default=0)
        # preserve the caller's column order (e.g. a loaded file header);
        # extra (dynamic) columns such as per-type probabilities keep
        # their position between declared ones
        for name, values in data.items():
            if name not in self._schema:
                dtype = float if values and isinstance(values[0], float) else str
                extra = Column(name, dtype, None)
                self._extra_columns.append(extra)
            self._data[name] = list(values)
        # append declared columns the caller did not provide
        for column in columns:
            if column.name not in self._data:
                self._data[column.name] = [column.default] * length

    # -- container protocol -------------------------------------------------

    def __bool__(self) -> bool:
        return len(self) != 0

    def __len__(self) -> int:
        return len(next(iter(self._data.values()), []))

    def __getattr__(self, name: str) -> list:
        data = self.__dict__.get("_data", {})
        if name in data:
            return data[name]
        raise AttributeError(name)

    def __iadd__(self: _T, rhs: object) -> _T:
        if not isinstance(rhs, type(self)):
            return NotImplemented  # type: ignore[return-value]
        for name, values in rhs._data.items():
            if name in self._data:
                self._data[name].extend(values)
            else:
                length = len(self)
                column = rhs._column(name)
                self._extra_columns.append(column)
                fill = math.nan if column.dtype is float else column.default
                self._data[name] = [fill] * (length - len(values)) + list(values)
        return self

    @property
    def columns(self) -> List[str]:
        return list(self._data)

    def _column(self, name: str) -> Column:
        if name in self._schema:
            return self._schema[name]
        for column in self._extra_columns:
            if column.name == name:
                return column
        raise KeyError(name)

    def rows(self) -> Iterator[Dict[str, object]]:
        names = self.columns
        for i in range(len(self)):
            yield {name: self._data[name][i] for name in names}

    # -- serialization ------------------------------------------------------

    @classmethod
    def load(cls: Type[_T], fh: Union[BinaryIO, str, "os.PathLike[str]"]) -> _T:
        if hasattr(fh, "read"):
            raw = fh.read()  # type: ignore[union-attr]
            text = raw.decode() if isinstance(raw, bytes) else raw
        else:
            with open(os.fspath(fh), "r") as f:  # type: ignore[arg-type]
                text = f.read()
        lines = text.splitlines()
        if not lines:
            return cls()
        header = lines[0].split("\t")
        schema = {c.name: c for c in cls._get_columns()}
        dtypes = [schema[name].dtype if name in schema else str for name in header]
        data: Dict[str, list] = {name: [] for name in header}
        for line in lines[1:]:
            if not line:
                continue
            cells = line.split("\t")
            for name, dtype, cell in zip(header, dtypes, cells):
                data[name].append(_parse_cell(cell, dtype))
        # infer float dtype for extra columns that parse as floats
        for j, name in enumerate(header):
            if name not in schema and data[name]:
                try:
                    data[name] = [math.nan if v == "" else float(v) for v in data[name]]
                except (TypeError, ValueError):
                    pass
        return cls(data)

    @classmethod
    def loads(cls: Type[_T], s: bytes) -> _T:
        return cls.load(io.BytesIO(s))

    def _dump_columns(self) -> List[str]:
        """Column names to write, eliding all-default declared columns."""
        names: List[str] = []
        for name in self.columns:
            column = self._schema.get(name)
            if (
                not self._KEEP_ALL_COLUMNS
                and column is not None
                and column.default is not None
            ):
                values = self._data[name]
                if isinstance(column.default, float) and math.isnan(column.default):
                    if all(isinstance(v, float) and math.isnan(v) for v in values):
                        continue
                elif all(v == column.default for v in values):
                    continue
            names.append(name)
        return names

    def dump(self, fh: Union[BinaryIO, str, "os.PathLike[str]"]) -> None:
        names = self._dump_columns()
        dtypes = [self._column(name).dtype for name in names]
        buffer = io.StringIO()
        buffer.write("\t".join(names))
        buffer.write("\r\n")
        for i in range(len(self)):
            buffer.write(
                "\t".join(
                    _format_cell(self._data[name][i], dtype)
                    for name, dtype in zip(names, dtypes)
                )
            )
            buffer.write("\r\n")
        payload = buffer.getvalue()
        if hasattr(fh, "write"):
            try:
                fh.write(payload.encode())  # type: ignore[union-attr]
            except TypeError:
                fh.write(payload)  # type: ignore[union-attr]
        else:
            with open(os.fspath(fh), "w") as f:  # type: ignore[arg-type]
                f.write(payload)

    def dumps(self) -> bytes:
        buffer = io.BytesIO()
        self.dump(buffer)
        return buffer.getvalue()
