"""TLC ``.cfg`` parser — the compatibility surface of the checker.

``CHECKER=tpu`` must load the reference's per-variant cfg files unmodified
(SURVEY.md §5.6), covering the grammar actually used by the nine configs:
``CONSTANTS`` (model values, model-value sets, numbers, booleans),
``INIT``/``NEXT``, ``VIEW``, ``SYMMETRY``, ``INVARIANT``, plus
commented-out ``SPECIFICATION``/``PROPERTY`` lines. Two reference cfgs are
deliberately broken and must be *diagnosed*, not crashed on
(SURVEY.md §2.2): ``PullRaft.cfg`` references undeclared model value
``v2``; ``RaftWithReconfigAddRemove.cfg`` omits the required
``MaxClusterSize`` constant (checked by the per-spec builder).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class CfgError(Exception):
    pass


@dataclass
class ModelValue:
    """A TLC model value (``n1 = n1``): an opaque symbolic constant."""

    name: str

    def __repr__(self):
        return self.name


@dataclass
class Cfg:
    path: str
    constants: dict[str, object] = field(default_factory=dict)  # name -> value
    init: str | None = None
    next: str | None = None
    view: str | None = None
    symmetry: str | None = None
    invariants: list[str] = field(default_factory=list)
    properties: list[str] = field(default_factory=list)
    constraints: list[str] = field(default_factory=list)
    specification: str | None = None
    # declaration order of model values (TLC set/order determinism)
    model_values: list[str] = field(default_factory=list)
    # recoverable cfg bugs found while parsing (e.g. PullRaft.cfg's
    # undeclared `v2`); parse_cfg raises on these unless lenient=True
    diagnostics: list[str] = field(default_factory=list)
    # whether recoverable bugs should be repaired (set by parse_cfg; spec
    # builders consult this for builder-level diagnoses such as the missing
    # MaxClusterSize in RaftWithReconfigAddRemove.cfg)
    lenient: bool = False

    def server_like(self, name: str) -> list[str]:
        v = self.constants.get(name)
        if not isinstance(v, tuple):
            raise CfgError(f"{self.path}: constant {name} is not a set")
        return [x.name for x in v]


_SECTIONS = {
    "SPECIFICATION",
    "CONSTANTS",
    "CONSTANT",
    "INIT",
    "NEXT",
    "VIEW",
    "SYMMETRY",
    "INVARIANT",
    "INVARIANTS",
    "PROPERTY",
    "PROPERTIES",
    "CONSTRAINT",
    "CONSTRAINTS",
}


def _strip_comment(line: str) -> str:
    i = line.find("\\*")
    return line[:i] if i >= 0 else line


def parse_cfg(path: str, text: str | None = None, lenient: bool = False) -> Cfg:
    """Parse a TLC cfg. ``lenient=True`` downgrades recoverable cfg bugs
    (see Cfg.diagnostics) from errors to recorded diagnostics, applying the
    obvious repair — e.g. ``PullRaft.cfg:9-11`` uses ``v2`` in the Value set
    without declaring it as a model value; the repair declares it."""
    if text is None:
        with open(path) as f:
            text = f.read()
    cfg = Cfg(path=path, lenient=lenient)
    section = None
    pending: list[str] = []  # tokens for CONSTANTS assignments spanning lines

    def flush_assignment(tokens: list[str]):
        if not tokens:
            return
        m = re.match(r"^\s*(\w+)\s*=\s*(.+?)\s*$", " ".join(tokens))
        if not m:
            raise CfgError(f"{path}: cannot parse constant assignment: {' '.join(tokens)!r}")
        name, rhs = m.group(1), m.group(2)
        cfg.constants[name] = _parse_value(cfg, name, rhs, path)

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        head = line.split()[0]
        if head in _SECTIONS:
            flush_assignment(pending)
            pending = []
            section = head
            rest = line[len(head) :].strip()
            if not rest:
                continue
            line = rest
        if section in ("CONSTANTS", "CONSTANT"):
            # assignments may span lines; a new assignment starts with `name =`
            if re.match(r"^\w+\s*=", line) and pending:
                flush_assignment(pending)
                pending = []
            pending.append(line)
            if _balanced(" ".join(pending)) and "=" in " ".join(pending):
                flush_assignment(pending)
                pending = []
        elif section == "SPECIFICATION":
            cfg.specification = line
        elif section == "INIT":
            cfg.init = line
        elif section == "NEXT":
            cfg.next = line
        elif section == "VIEW":
            cfg.view = line
        elif section == "SYMMETRY":
            cfg.symmetry = line
        elif section in ("INVARIANT", "INVARIANTS"):
            cfg.invariants += line.split()
        elif section in ("PROPERTY", "PROPERTIES"):
            cfg.properties += line.split()
        elif section in ("CONSTRAINT", "CONSTRAINTS"):
            cfg.constraints += line.split()
        elif section is None:
            raise CfgError(f"{path}: content before any section keyword: {line!r}")
    flush_assignment(pending)
    if cfg.diagnostics and not lenient:
        raise CfgError("; ".join(cfg.diagnostics))
    return cfg


def _balanced(s: str) -> bool:
    return s.count("{") == s.count("}")


def _parse_value(cfg: Cfg, name: str, rhs: str, path: str):
    rhs = rhs.strip()
    if rhs.startswith("{"):
        if not rhs.endswith("}"):
            raise CfgError(f"{path}: unterminated set literal for {name}")
        items = [t for t in re.split(r"[\s,]+", rhs[1:-1].strip()) if t]
        out = []
        for t in items:
            if re.fullmatch(r"-?\d+", t):
                out.append(int(t))
                continue
            mv = _lookup_model_value(cfg, t)
            if mv is None:
                cfg.diagnostics.append(
                    f"{path}: set {name} references undeclared model value {t!r} "
                    f"(declared: {', '.join(cfg.model_values) or 'none'}); "
                    f"lenient mode repairs this by declaring it"
                )
                mv = ModelValue(t)
                cfg.constants[t] = mv
                cfg.model_values.append(t)
            out.append(mv)
        return tuple(out)
    if re.fullmatch(r"-?\d+", rhs):
        return int(rhs)
    if rhs == "TRUE":
        return True
    if rhs == "FALSE":
        return False
    if rhs == name:  # model value declaration: `n1 = n1`
        mv = ModelValue(name)
        cfg.model_values.append(name)
        return mv
    # reference to a previously declared model value or constant
    if rhs in cfg.constants:
        return cfg.constants[rhs]
    raise CfgError(f"{path}: cannot parse value {rhs!r} for constant {name}")


def _lookup_model_value(cfg: Cfg, token: str):
    v = cfg.constants.get(token)
    if isinstance(v, ModelValue):
        return v
    return None
