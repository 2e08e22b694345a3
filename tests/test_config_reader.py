"""The flat study-config reader against PyYAML on every shipped config."""

import pathlib

import pytest

from bark_jax.utils.config import load_config, parse_scalar

CONFIGS = sorted(
    (pathlib.Path(__file__).resolve().parents[1] / "examples" / "configs")
    .glob("*.yaml")
)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_reader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    assert load_config(path) == yaml.safe_load(path.read_text())


def test_every_config_names_a_benchmark_or_model():
    assert len(CONFIGS) >= 10
    for path in CONFIGS:
        config = load_config(path)
        assert ("benchmark" in config) != ("model" in config), path


@pytest.mark.parametrize(
    "text,value",
    [("50", 50), ("0.95", 0.95), ("1e-3", 1e-3), ("true", True),
     ("False", False), ("null", None), ("BARK", "BARK"), ("'a b'", "a b")],
)
def test_parse_scalar(text, value):
    assert parse_scalar(text) == value


@pytest.mark.parametrize(
    "body",
    ["model: BARK\n- item\n", "a:\n  b:\n    c: 1\n", "  x: 1\n",
     "list: [1, 2]\n", "key:\n  inner: {a: 1}\n", "text: |\n  body\n"],
    ids=["list_item", "two_levels", "orphan_indent", "flow_list",
         "flow_mapping", "block_scalar"],
)
def test_reader_rejects_what_it_cannot_read(tmp_path, body):
    path = tmp_path / "bad.yaml"
    path.write_text(body)
    with pytest.raises(ValueError):
        load_config(path)
