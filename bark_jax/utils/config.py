"""Study configs (``examples/configs/*.yaml``) read without PyYAML.

The configs use a flat subset of YAML: ``# comments``, top-level
``key: scalar`` lines, and top-level ``key:`` lines opening one level of
indented ``key: scalar`` pairs. Scalars are ints, floats, booleans, null or
plain strings. Anything else is rejected with its line number rather than
read wrongly.
"""

from __future__ import annotations

from pathlib import Path


def parse_scalar(text: str):
    """A YAML plain scalar: bool, null, int, float, else a string."""
    text = text.strip()
    if text in ("true", "True"):
        return True
    if text in ("false", "False"):
        return False
    if text in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def load_config(path) -> dict:
    """Read a flat study config into a dict (nested one level at most)."""
    path = Path(path)
    config: dict = {}
    section: dict | None = None
    for lineno, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        key, sep, value = line.strip().partition(":")
        if not sep or not key or any(c in key for c in "[]{}-"):
            raise ValueError(f"{path}:{lineno}: expected 'key: value': {raw!r}")
        if value.strip()[:1] in tuple("[{|>&*!"):
            raise ValueError(f"{path}:{lineno}: not a plain scalar: {raw!r}")
        if not line.startswith(" "):
            if value.strip():
                config[key] = parse_scalar(value)
                section = None
            else:
                section = config[key] = {}
        elif section is not None:
            if not value.strip():
                raise ValueError(
                    f"{path}:{lineno}: only one level of nesting: {raw!r}"
                )
            section[key] = parse_scalar(value)
        else:
            raise ValueError(f"{path}:{lineno}: indented line outside a section")
    return config
