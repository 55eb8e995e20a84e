"""Hydra/OmegaConf-style configs on plain dicts, with a YAML reader and
writer on the standard library.

Counterpart of ``diffusion_model_nemo_tpu/config/yaml_config.py`` (the same
public surface: :class:`Config`, :func:`load_config`, :func:`apply_overrides`,
:func:`merge`, :func:`resolve_interpolations`, :func:`to_yaml`,
:func:`from_dict`, :func:`to_dict`). The JAX module parses with PyYAML; the
card's machine has none, so this module reads the subset of YAML that the
repository's configs and ``yaml.safe_dump``'s output use:

- comments; block mappings; block sequences (also the indentless form
  ``safe_dump`` writes under a key); flow sequences and flow mappings, also
  across lines; single- and double-quoted scalars on one line; a leading
  ``---``;
- plain scalars resolved as PyYAML's loader with the JAX package's
  ``_FloatSafeLoader`` resolves them: ``null``/``~``/empty, ``true``/``false``
  (any case form PyYAML takes), decimal ints, floats with or without a dot
  (``1e-4``, ``1.0e-05``, ``.inf``, ``.nan``), ``???`` as a string.

Everything else raises :class:`YAMLError` naming the line: anchors, aliases,
tags, block scalars (``|``, ``>``), multi-line plain or quoted scalars,
complex keys, several documents, and plain scalars that YAML 1.1 would read
as something this reader does not produce (``yes``/``no``/``on``/``off``,
octal, hex or binary ints, digits with ``_``, sexagesimal numbers,
timestamps, ``<<``, ``=``). The reader never guesses.

:func:`to_yaml` writes block mappings, flow lists of scalars and quotes every
string that a reader could take for another type, so its output reads back
to the same dict here and under PyYAML (``safe_load`` and the float-safe
loader alike).
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Any, Iterable, List, Mapping, Optional, Tuple, Union

__all__ = [
    "Config",
    "YAMLError",
    "load_config",
    "parse_yaml",
    "parse_value",
    "to_yaml",
    "from_dict",
    "to_dict",
    "apply_overrides",
    "resolve_interpolations",
    "merge",
    "MISSING",
]

# Hydra's mandatory-value marker ``???`` reads as the string "???".
MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class YAMLError(ValueError):
    """YAML outside the subset this reader takes, or malformed."""


# ------------------------------------------------------------------ Config --
class Config(dict):
    """Dict with attribute access and nested-wrapping semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name, value) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def copy(self) -> "Config":
        return copy.deepcopy(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config({k: _wrap(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def from_dict(d: Optional[Mapping]) -> Config:
    """Deep copy of ``d`` as nested :class:`Config`."""
    return _wrap(copy.deepcopy(dict(d)) if d else {})


def to_dict(cfg: Any) -> Any:
    """Recursively convert Config → plain dict (for YAML dump / checkpoints)."""
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


# --------------------------------------------------------- plain scalars ----
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9]+\.[0-9]*(?:[eE][-+]?[0-9]+)?|\.[0-9]+(?:[eE][-+]?[0-9]+)?|[0-9]+[eE][-+]?[0-9]+)"
)
_INF_NAN = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf, "+.inf": math.inf,
            "+.Inf": math.inf, "+.INF": math.inf, "-.inf": -math.inf, "-.Inf": -math.inf,
            "-.INF": -math.inf, ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
# Plain scalars that PyYAML (YAML 1.1) reads as a bool, int, float, date,
# merge key or value key in forms this reader does not produce: refused.
_AMBIGUOUS = re.compile(
    r"""(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
    |[-+]?[0-9][0-9_]*(?:\.[0-9_]*)?(?:[eE][-+]?[0-9_]+)?
    |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*
    |<<|=)""",
    re.X,
)


def _resolve_plain(s: str, where: str) -> Any:
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if s in _INF_NAN:
        return _INF_NAN[s]
    if _AMBIGUOUS.fullmatch(s):
        raise YAMLError(f"{where}: plain scalar {s!r} reads differently under YAML 1.1; quote it")
    return s


# ------------------------------------------------------------------ reader --
_TOKEN_START = set("[{,")


def _strip_comment(line: str, where: str) -> str:
    """The line without its comment; quotes are tracked where a scalar may
    begin, so ``it's`` in a plain scalar opens no quote."""
    i, n, quote, at_start = 0, len(line), None, True
    while i < n:
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if i + 1 < n and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        elif ch in "'\"" and at_start:
            quote = ch
        elif ch in " \t":
            i += 1
            continue
        at_start = ch in _TOKEN_START or (ch in ":-?" and i + 1 < n and line[i + 1] in " \t")
        i += 1
    if quote is not None:
        raise YAMLError(f"{where}: quoted scalar does not end on its line (multi-line scalars are not supported)")
    return line.rstrip()


_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
               "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
               "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``; returns (value, end)."""
    q, i, out = text[pos], pos + 1, []
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if i + 1 < len(text) and text[i + 1] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and ch == '"':
            return "".join(out), i + 1
        if q == '"' and ch == "\\":
            esc = text[i + 1 : i + 2]
            if esc in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[esc])
                i += 2
                continue
            if esc in _DQ_HEX:
                digits = text[i + 2 : i + 2 + _DQ_HEX[esc]]
                if len(digits) != _DQ_HEX[esc] or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YAMLError(f"{where}: bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + _DQ_HEX[esc]
                continue
            raise YAMLError(f"{where}: unknown escape \\{esc}")
        out.append(ch)
        i += 1
    raise YAMLError(f"{where}: unterminated quoted scalar (multi-line scalars are not supported)")


def _refuse_indicator(s: str, where: str) -> None:
    if not s:
        return
    if s[0] in "&*!":
        kind = {"&": "anchors", "*": "aliases", "!": "tags"}[s[0]]
        raise YAMLError(f"{where}: {kind} are not supported: {s!r}")
    if s[0] in "|>":
        raise YAMLError(f"{where}: block scalars ({s[0]}) are not supported")
    if s[0] in "%@`":
        raise YAMLError(f"{where}: reserved indicator {s[0]!r}")
    if s[0] == "?" and (len(s) == 1 or s[1] in " \t"):
        raise YAMLError(f"{where}: complex keys (?) are not supported")


class _Flow:
    """Recursive-descent parser of one flow collection (possibly joined from
    several lines)."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def _skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        self._skip()
        return self.text[self.pos : self.pos + 1]

    def node(self) -> Any:
        ch = self._peek()
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        return self._scalar()

    def _scalar(self) -> Any:
        ch = self._peek()
        if ch in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos, self.where)
            return value
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 == len(self.text) or self.text[self.pos + 1] in " \t,[]{}"):
                break
            self.pos += 1
        s = self.text[start : self.pos].strip()
        _refuse_indicator(s, self.where)
        return _resolve_plain(s, self.where)

    def _expect(self, ch: str) -> None:
        if self._peek() != ch:
            raise YAMLError(f"{self.where}: expected {ch!r} in flow collection {self.text!r}")
        self.pos += 1

    def _seq(self) -> list:
        self._expect("[")
        out = []
        while self._peek() != "]":
            if not self._peek():
                raise YAMLError(f"{self.where}: unterminated flow sequence")
            out.append(self.node())
            if self._peek() == ":":
                raise YAMLError(f"{self.where}: single-pair mappings in a flow sequence are not supported")
            if self._peek() != "]":
                self._expect(",")
        self.pos += 1
        return out

    def _map(self) -> dict:
        self._expect("{")
        out = {}
        while self._peek() != "}":
            if not self._peek():
                raise YAMLError(f"{self.where}: unterminated flow mapping")
            key = self._scalar()
            self._expect(":")
            out[key] = None if self._peek() in (",", "}") else self.node()
            if self._peek() != "}":
                self._expect(",")
        self.pos += 1
        return out

    def done(self) -> None:
        if self._peek():
            raise YAMLError(f"{self.where}: unexpected text after a flow collection: {self.text[self.pos:]!r}")


def _flow_depth(s: str) -> int:
    """Open brackets left at the end of ``s`` (quoted scalars skipped)."""
    depth, i = 0, 0
    while i < len(s):
        ch = s[i]
        if ch in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
            _, i = _quoted(s, i, "")
            continue
        depth += ch in "[{"
        depth -= ch in "]}"
        i += 1
    return depth


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        started = False
        for n, raw in enumerate(text.splitlines(), 1):
            where = f"{name}:{n}"
            lead = raw[: len(raw) - len(raw.lstrip(" \t"))]
            if "\t" in lead and raw.strip():
                raise YAMLError(f"{where}: tabs in indentation are not supported")
            content = _strip_comment(raw.strip(), where)
            if not content:
                continue
            if content.startswith("%"):
                raise YAMLError(f"{where}: directives are not supported")
            if content in ("---", "...") or content.startswith("--- "):
                if started or content != "---":
                    raise YAMLError(f"{where}: one document per file, with no content on the '---' line")
                continue
            started = True
            self.lines.append((n, len(lead), content))

    def where(self, i: int) -> str:
        return f"{self.name}:{self.lines[i][0]}" if i < len(self.lines) else f"{self.name}:end"

    # A block-mapping line: `key:` or `key: value`; returns (key, rest) or None.
    def _split_key(self, i: int):
        content, where = self.lines[i][2], self.where(i)
        if content[0] in "'\"":
            key, end = _quoted(content, 0, where)
            rest = content[end:]
            if not rest.startswith(":") or (len(rest) > 1 and rest[1] not in " \t"):
                return None
            return key, rest[1:].strip()
        if content[0] in "[{" or (content[0] == "-" and (len(content) == 1 or content[1] in " \t")):
            return None
        m = re.search(r":(?:[ \t]|$)", content)
        if m is None:
            return None
        key_s = content[: m.start()].strip()
        _refuse_indicator(key_s, where)
        return _resolve_plain(key_s, where), content[m.end() :].strip()

    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.node(0, -1)
        if i < len(self.lines):
            raise YAMLError(f"{self.where(i)}: unexpected content (bad indentation?)")
        return value

    def node(self, i: int, parent: int) -> Tuple[Any, int]:
        """The block node starting at line ``i`` (indented beyond ``parent``)."""
        if i >= len(self.lines) or self.lines[i][1] <= parent:
            return None, i
        _, indent, content = self.lines[i]
        if content == "-" or content.startswith(("- ", "-\t")):
            return self.seq(i, indent)
        if self._split_key(i) is not None:
            return self.mapping(i, indent)
        value, j = self.inline(content, i)
        return value, j

    def inline(self, text: str, i: int) -> Tuple[Any, int]:
        """A value written on line ``i`` (a flow collection may continue on
        the following lines); returns (value, next line)."""
        where = self.where(i)
        j = i + 1
        if text[0] in "[{":
            while _flow_depth(text) > 0:
                if j >= len(self.lines):
                    raise YAMLError(f"{where}: unterminated flow collection")
                text += " " + self.lines[j][2]
                j += 1
            flow = _Flow(text, where)
            value = flow.node()
            flow.done()
            return value, j
        if text[0] in "'\"":
            value, end = _quoted(text, 0, where)
            if text[end:].strip():
                raise YAMLError(f"{where}: unexpected text after a quoted scalar: {text[end:]!r}")
            return value, j
        _refuse_indicator(text, where)
        if re.search(r":(?:[ \t]|$)", text):
            raise YAMLError(f"{where}: a mapping is not allowed here: {text!r}")
        return _resolve_plain(text, where), j

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i][1] == indent:
            kv = self._split_key(i)
            if kv is None:
                raise YAMLError(f"{self.where(i)}: expected `key: value` in a block mapping")
            key, rest = kv
            if key == "<<":
                raise YAMLError(f"{self.where(i)}: merge keys are not supported")
            if rest:
                value, i = self.inline(rest, i)
            else:
                nxt = self.lines[i + 1] if i + 1 < len(self.lines) else None
                if nxt is not None and nxt[1] == indent and (nxt[2] == "-" or nxt[2].startswith(("- ", "-\t"))):
                    value, i = self.seq(i + 1, indent)  # the indentless form
                else:
                    value, i = self.node(i + 1, indent)
            out[key] = value
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise YAMLError(f"{self.where(i)}: unexpected indentation (multi-line scalars are not supported)")
        return out, i

    def seq(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i][1] == indent:
            n, _, content = self.lines[i]
            if not (content == "-" or content.startswith(("- ", "-\t"))):
                break
            rest = content[1:].lstrip(" \t")
            if not rest:
                value, i = self.node(i + 1, indent)
            else:
                # `- key: v` or `- - x`: a nested node whose indent is the column of `rest`.
                col = indent + len(content) - len(rest)
                self.lines[i] = (n, col, rest)
                if rest == "-" or rest.startswith(("- ", "-\t")) or self._split_key(i) is not None:
                    value, i = self.node(i, indent)
                else:
                    value, i = self.inline(rest, i)
            out.append(value)
        if i < len(self.lines) and self.lines[i][1] > indent:
            raise YAMLError(f"{self.where(i)}: unexpected indentation (multi-line scalars are not supported)")
        return out, i


def parse_yaml(text: str, name: str = "<string>") -> Any:
    """One YAML document of the supported subset → dicts, lists, scalars."""
    return _Reader(text, name).document()


def parse_value(raw: str) -> Any:
    """A one-line YAML value (an override's right-hand side): a plain or
    quoted scalar, or a flow collection."""
    if raw.strip() == "":
        return None
    reader = _Reader(raw, "<override>")
    if len(reader.lines) != 1:
        raise YAMLError(f"override value {raw!r} must be one line")
    value, _ = reader.inline(reader.lines[0][2], 0)
    return value


# ------------------------------------------------------------------ writer --
_PLAIN_BLOCK = re.compile(r"[A-Za-z0-9_$./][A-Za-z0-9_ $./{}()+\-=<>~^]*")
_PLAIN_FLOW = re.compile(r"[A-Za-z0-9_$./][A-Za-z0-9_ $./()+\-=<>~^]*")


def _format_str(s: str, flow: bool) -> str:
    plain = (_PLAIN_FLOW if flow else _PLAIN_BLOCK).fullmatch(s)
    if plain and s == s.strip():
        try:
            if _resolve_plain(s, "") == s:
                return s
        except YAMLError:
            pass
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    out = []
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch.isprintable():
            out.append(ch)
        else:
            out.append(f"\\x{ord(ch):02X}" if ord(ch) < 0x100 else f"\\u{ord(ch):04X}" if ord(ch) < 0x10000 else f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _format_float(v: float) -> str:
    """PyYAML's float form: ``1.0e-05`` (a dot before the exponent, so that
    YAML 1.1 readers take it as a float), ``.inf``, ``.nan``."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    r = repr(v).lower()
    if "." not in r and "e" in r:
        r = r.replace("e", ".0e", 1)
    return r


def _format_scalar(v: Any, flow: bool = False) -> str:
    if hasattr(v, "item") and not isinstance(v, (str, bytes)) and getattr(v, "ndim", 1) == 0:
        v = v.item()  # a numpy or torch scalar
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _format_float(v)
    if isinstance(v, str):
        return _format_str(v, flow)
    raise TypeError(f"to_yaml cannot write a {type(v).__name__}: {v!r}")


def _is_scalar(v: Any) -> bool:
    return not isinstance(v, (Mapping, list, tuple))


def _flow(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{" + ", ".join(f"{_format_scalar(k, True)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _format_scalar(v, flow=True)


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, Mapping):
        for k, x in v.items():
            key = _format_scalar(k)
            if isinstance(x, Mapping) and x:
                out.append(f"{pad}{key}:")
                _emit(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x and not all(map(_is_scalar, x)):
                out.append(f"{pad}{key}:")
                _emit(x, indent, out)
            else:
                out.append(f"{pad}{key}: {_flow(x) if not _is_scalar(x) else _format_scalar(x)}")
        return
    for x in v:  # a block sequence
        if isinstance(x, Mapping) and x:
            sub: List[str] = []
            _emit(x, indent + 2, sub)
            sub[0] = pad + "- " + sub[0][indent + 2 :]
            out.extend(sub)
        elif isinstance(x, (list, tuple)) and x and not all(map(_is_scalar, x)):
            out.append(f"{pad}-")
            _emit(x, indent + 2, out)
        else:
            out.append(f"{pad}- {_flow(x) if not _is_scalar(x) else _format_scalar(x)}")


def to_yaml(cfg: Any) -> str:
    """Block-style YAML of a mapping (lists of scalars in flow style)."""
    data = to_dict(cfg)
    if not isinstance(data, Mapping):
        raise TypeError("to_yaml writes a mapping")
    if not data:
        return "{}\n"
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n"


# ----------------------------------------------------------- config layer --
def load_config(
    path: Union[str, Path], overrides: Optional[Iterable[str]] = None, resolve: bool = True
) -> Config:
    path = Path(path)
    cfg = from_dict(parse_yaml(path.read_text(), name=str(path)) or {})
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg


def merge(base: Mapping, *others: Mapping) -> Config:
    """Deep-merge dicts; later values win (like OmegaConf.merge)."""
    out = from_dict(base)
    for other in others:
        _merge_into(out, other)
    return out


def _merge_into(dst: Config, src: Mapping) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Mapping) and isinstance(v, Mapping):
            _merge_into(dst[k], v)
        else:
            dst[k] = _wrap(copy.deepcopy(v))


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply ``key.path=value`` overrides; ``+key.path=value`` creates new keys."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override `{ov}` must look like key.path=value")
        key, _, raw = ov.partition("=")
        allow_new = key.startswith("+")
        key = key.lstrip("+~")
        value = parse_value(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                if not allow_new:
                    raise KeyError(f"Override key `{key}` not found (use +{key}= to add)")
                node[p] = Config()
            node = node[p]
            if not isinstance(node, Mapping):
                raise KeyError(f"Override key `{key}` traverses non-dict node `{p}`")
        leaf = parts[-1]
        if leaf not in node and not allow_new:
            raise KeyError(f"Override key `{key}` not found (use +{key}= to add)")
        node[leaf] = _wrap(value)
    return cfg


def _lookup(root: Mapping, dotted: str) -> Any:
    node: Any = root
    for p in dotted.split("."):
        if isinstance(node, Mapping) and p in node:
            node = node[p]
        else:
            raise KeyError(f"Interpolation `${{{dotted}}}` not found in config")
    return node


def resolve_interpolations(cfg: Config, _root: Optional[Config] = None) -> Config:
    """Substitute ``${a.b}`` references against the config root (iteratively,
    so chained interpolations resolve)."""
    root = cfg if _root is None else _root

    def resolve_value(v: Any) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v)
            if m:  # whole-string interpolation keeps the referenced type
                return resolve_value(_lookup(root, m.group(1)))
            return _INTERP_RE.sub(lambda mm: str(resolve_value(_lookup(root, mm.group(1)))), v)
        if isinstance(v, Mapping):
            return Config({k: resolve_value(x) for k, x in v.items()})
        if isinstance(v, list):
            return [resolve_value(x) for x in v]
        return v

    return resolve_value(cfg)
