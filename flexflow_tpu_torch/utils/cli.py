"""Declarative CLI spec + parser (copy of flexflow_tpu/utils/cli.py).

Reference: lib/utils/include/utils/cli/ (CLISpec, CLIFlagSpec,
CLIPositionalArgumentSpec, cli_parse, cli_get_help_message) — a tiny
declarative argument model the reference's tools (bin/export-model-arch)
build on. Same model here: specs are data, parsing is one function, and the
result is queried by key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union


@dataclass(frozen=True)
class CLIFlagKey:
    name: str


@dataclass(frozen=True)
class CLIPositionalKey:
    index: int


CLIKey = Union[CLIFlagKey, CLIPositionalKey]


@dataclass
class CLIFlagSpec:
    """--long/-s flag. type=bool makes it a store-true switch."""

    long_name: str
    short_name: Optional[str] = None
    type: type = str
    default: object = None
    help: str = ""
    choices: Optional[Sequence[str]] = None


@dataclass
class CLIPositionalSpec:
    name: str
    type: type = str
    help: str = ""
    choices: Optional[Sequence[str]] = None


@dataclass
class CLISpec:
    program: str = ""
    description: str = ""
    flags: List[CLIFlagSpec] = field(default_factory=list)
    positionals: List[CLIPositionalSpec] = field(default_factory=list)

    def add_flag(self, *args, **kwargs) -> CLIFlagKey:
        f = CLIFlagSpec(*args, **kwargs)
        self.flags.append(f)
        return CLIFlagKey(f.long_name)

    def add_positional(self, *args, **kwargs) -> CLIPositionalKey:
        p = CLIPositionalSpec(*args, **kwargs)
        self.positionals.append(p)
        return CLIPositionalKey(len(self.positionals) - 1)


@dataclass
class CLIParseResult:
    spec: CLISpec
    flag_values: Dict[str, object]
    positional_values: List[object]

    def get(self, key: CLIKey):
        if isinstance(key, CLIFlagKey):
            return self.flag_values[key.name]
        return self.positional_values[key.index]

    def __getitem__(self, key):
        if isinstance(key, (CLIFlagKey, CLIPositionalKey)):
            return self.get(key)
        return self.flag_values[key]


class CLIParseError(ValueError):
    pass


def cli_get_help_message(spec: CLISpec) -> str:
    lines = []
    pos = " ".join(f"<{p.name}>" for p in spec.positionals)
    lines.append(f"usage: {spec.program or 'prog'} [options] {pos}".rstrip())
    if spec.description:
        lines.append(spec.description)
    if spec.positionals:
        lines.append("positional arguments:")
        for p in spec.positionals:
            ch = f" (choices: {', '.join(p.choices)})" if p.choices else ""
            lines.append(f"  {p.name:<20} {p.help}{ch}")
    if spec.flags:
        lines.append("options:")
        for f in spec.flags:
            names = f"--{f.long_name}"
            if f.short_name:
                names += f", -{f.short_name}"
            ch = f" (choices: {', '.join(f.choices)})" if f.choices else ""
            dfl = "" if f.default is None else f" [default: {f.default}]"
            lines.append(f"  {names:<20} {f.help}{ch}{dfl}")
    return "\n".join(lines)


def _convert(spec_type: type, raw: str, what: str):
    try:
        if spec_type is bool:
            return raw.lower() in ("1", "true", "yes")
        return spec_type(raw)
    except ValueError as e:
        raise CLIParseError(f"bad value for {what}: {raw!r}") from e


def cli_parse(spec: CLISpec, argv: Sequence[str]) -> CLIParseResult:
    """Parse argv (without the program name). Unknown flags raise."""
    by_long = {f.long_name: f for f in spec.flags}
    by_short = {f.short_name: f for f in spec.flags if f.short_name}
    flag_values: Dict[str, object] = {
        f.long_name: (False if f.type is bool else f.default) for f in spec.flags
    }
    positionals: List[object] = []
    i = 0
    args = list(argv)
    while i < len(args):
        a = args[i]
        if a.startswith("--") or (a.startswith("-") and len(a) > 1 and not a[1].isdigit()):
            if a.startswith("--"):
                name, _, inline = a[2:].partition("=")
                f = by_long.get(name)
            else:
                name, inline = a[1:], ""
                f = by_short.get(name)
            if f is None:
                raise CLIParseError(f"unknown flag: {a}")
            if f.type is bool:
                flag_values[f.long_name] = True
            else:
                if inline:
                    raw = inline
                else:
                    i += 1
                    if i >= len(args):
                        raise CLIParseError(f"flag {a} needs a value")
                    raw = args[i]
                if f.choices and raw not in f.choices:
                    raise CLIParseError(
                        f"flag --{f.long_name}: {raw!r} not in {list(f.choices)}"
                    )
                flag_values[f.long_name] = _convert(f.type, raw, f"--{f.long_name}")
        else:
            idx = len(positionals)
            if idx >= len(spec.positionals):
                raise CLIParseError(f"unexpected positional argument: {a}")
            p = spec.positionals[idx]
            if p.choices and a not in p.choices:
                raise CLIParseError(
                    f"argument {p.name}: {a!r} not in {list(p.choices)}"
                )
            positionals.append(_convert(p.type, a, p.name))
        i += 1
    if len(positionals) < len(spec.positionals):
        missing = spec.positionals[len(positionals)].name
        raise CLIParseError(f"missing positional argument: {missing}")
    return CLIParseResult(spec, flag_values, positionals)
