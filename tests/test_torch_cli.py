"""The port's CLI (`python -m similaritysearchbyrdf_tpu_torch.cli`) against
the JAX package's: `genparams` writes the same file, `fit` saves a forest
either CLI can query, and `query` prints the same JSON lines: the same ids,
scores within 1e-5 (each CLI rounds them to 6 decimals)."""

import json
import os

import numpy as np
import pytest

from similaritysearchbyrdf_tpu import cli as jcli
from similaritysearchbyrdf_tpu_torch import cli
from similaritysearchbyrdf_tpu_torch.native import loader as native

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "densevectorfile")
CONF = ("mclab.lsh.tableNum = 3\nmclab.lsh.permutationNum = 1\n"
        "mclab.lsh.vectorDim = 16\nmclab.lshTable.chainLength = 10\n"
        "mclab.lsh.familySize = 24\nmclab.lsh.partitionBits=2\n")


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _data_file(tmp_path, n=240, d=16):
    rng = np.random.default_rng(6)
    c = rng.normal(size=(12, d))
    x = c[rng.integers(0, 12, n)] + 0.1 * rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    path = tmp_path / "d.txt"
    path.write_text("\n".join(f"[{i},[{','.join(repr(float(v)) for v in x[i])}]]"
                              for i in range(n)))
    return str(path)


def _same_answers(got, want):
    assert [r["query"] for r in got] == [r["query"] for r in want]
    for g, w in zip(got, want):
        assert g["ids"] == w["ids"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-5)


def test_genparams_writes_the_jax_file(tmp_path, capsys):
    conff = tmp_path / "c.conf"
    conff.write_text(CONF)
    assert cli.main(["genparams", "--config", str(conff), "--output", str(tmp_path / "p.txt"),
                     "--device", "cpu"]) == 0
    assert jcli.main(["genparams", "--config", str(conff),
                      "--output", str(tmp_path / "j.txt")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("p.txt", "j.txt") == out[1]
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("steps", [0, 1])
def test_fit_and_query_match_the_jax_cli(tmp_path, capsys, steps):
    data = _data_file(tmp_path)
    conff = tmp_path / "c.conf"
    conff.write_text(CONF)
    calls = native.CALLS
    assert cli.main(["fit", data, "--config", str(conff), "--output", str(tmp_path / "p"),
                     "--device", "cpu"]) == 0
    assert native.CALLS > calls, "the fit did not read its file through the native parser"
    assert jcli.main(["fit", data, "--config", str(conff), "--output", str(tmp_path / "j")]) == 0
    fit_lines = capsys.readouterr().out.strip().splitlines()
    assert fit_lines[0].replace(str(tmp_path / "p"), "X") == \
        fit_lines[1].replace(str(tmp_path / "j"), "X")
    args = [data, "--limit", "12", "--steps", str(steps), "--k", "5"]
    assert cli.main(["query", str(tmp_path / "p"), *args, "--device", "cpu"]) == 0
    port = _lines(capsys)
    assert jcli.main(["query", str(tmp_path / "j"), *args]) == 0
    jax = _lines(capsys)
    assert len(port) == 12 and all(len(r["ids"]) == 5 for r in port)
    _same_answers(port, jax)
    # each CLI queries the other's saved index alike
    assert cli.main(["query", str(tmp_path / "j"), *args, "--device", "cpu"]) == 0
    _same_answers(_lines(capsys), jax)
    assert jcli.main(["query", str(tmp_path / "p"), *args]) == 0
    _same_answers(_lines(capsys), port)


def test_fit_and_query_the_fixture_file(tmp_path, capsys):
    """`tests/fixtures/densevectorfile`: one vector; both CLIs return it."""
    for main, name, extra in ((cli.main, "p", ["--device", "cpu"]), (jcli.main, "j", [])):
        assert main(["fit", FIXTURE, "--output", str(tmp_path / name), *extra]) == 0
        assert main(["query", str(tmp_path / name), FIXTURE, *extra]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    port, jax = json.loads(out[1]), json.loads(out[3])
    assert port["ids"] == jax["ids"] == [0]
    np.testing.assert_allclose(port["scores"], jax["scores"], rtol=0, atol=1e-5)


def test_device_defaults_to_the_card():
    """Without `--device` the CLI runs on the first CUDA card, and without
    one it refuses rather than run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot happen")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["genparams", "--output", os.devnull])
