"""BENCHMARK.json against the contract's form, and every name it holds
found as a file of pvbench/."""
import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

from pvbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_unique_and_entry_keys():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_command_paths_and_run_seconds():
    assert BENCH["command"] == ["python3", "pvbench/run.py"]
    assert BENCH["paths"] == ["pvbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's allowance
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.cell(cell, BENCH)
    assert c["mix"]["loop"] in ("offline", "train")
    assert c["check"]["limits"]
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert conf["file"].startswith("pvbench/configs/")
    assert c["cfg"]["name"] == c["config"]
    assert c["cfg"]["reduced"] == conf["reduced"] == []


def test_every_config_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_module_found_and_moves_reported(metric):
    mod = spec.metric_module(metric["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        metric["unit"], metric["layer"], metric["moves"])
    assert mod.read({}) is None            # nothing to read: no number
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert metric["moves"] in spec.end_to_end(BENCH, cell)


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = spec.end_to_end(BENCH, cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, cell)


def test_no_jax_loaded_by_the_harness():
    """Importing the runner, the loops and the reference leaves no module
    whose top-level name, compared whole, is jax, jaxlib, flax or the JAX
    package (pvnet_tpu_torch begins with pvnet_tpu and is allowed)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import run\n"
        "from pvbench import offline, training, control, faults, trace\n"
        "from pvbench.reference import fcn, voting, pnp, augment, train\n"
        "import pvnet_tpu_torch.pipeline, pvnet_tpu_torch.train.trainer\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'pvnet_tpu'}))\n"
        "print('pvnet_tpu_torch' in top, run.forbidden_modules())\n"
        % (spec.ROOT, os.path.join(spec.ROOT, "pvbench")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "USE_FLAX": "0"}).stdout.split(
        "\n")
    assert out[0] == "[]"
    assert out[1] == "True []"


def test_forbidden_names_compared_whole():
    sys.path.insert(0, os.path.join(spec.ROOT, "pvbench"))
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["pvnet_tpu_torch_x"] = sys
        assert "pvnet_tpu" not in run.forbidden_modules()
        sys.modules["pvnet_tpu.ops"] = sys
        assert "pvnet_tpu" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(spec.HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("pvnet_tpu_torch", "pvnet_tpu",
                                               "jax", "flax"), (path, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pvbench.reference import fcn, voting, pnp, augment, train,"
            " lowp, msgpack\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pvnet_tpu_torch', 'pvnet_tpu', 'jax', 'flax'}))" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


# PVNet's published *_8s networks (lib/networks/model_repository.py):
# block, stage sizes, and fc, 8s, 4s, 2s and raw widths
PUBLISHED = {
    "resnet18_8s": ("BasicBlock", [2, 2, 2, 2], (256, 128, 64, 32, 32)),
    "resnet34_8s": ("BasicBlock", [3, 4, 6, 3], (256, 128, 64, 32, 32)),
    "resnet50_8s": ("Bottleneck", [3, 4, 6, 3], (384, 256, 128, 64, 64))}


def test_configuration_files_state_their_sources():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["set_from"] and cfg["weights"]
        block, stages, widths = PUBLISHED[cfg["network"]]
        assert (cfg["block"], cfg["stage_sizes"], cfg["output_stride"]) == (
            block, stages, 8)
        assert (cfg["fcdim"], cfg["s8dim"], cfg["s4dim"], cfg["s2dim"],
                cfg["raw_dim"]) == widths
        assert cfg["ver_dim"] == 2 * cfg["num_keypoints"]
        assert cfg["seg_dim"] == 2
