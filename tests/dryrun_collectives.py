"""The dry-run's collectives beside the reference's, recorded and not bound.

The reference's ``run_one`` (``repro.launch.dryrun``) lowers reduced
glm4-9b's train step, its multi-pod round step and its prefill for 8 forced
host devices, with ``make_production_mesh`` swapped for the host meshes
``(2, 4)`` (data, model) and ``(2, 2, 2)`` (pod, data, model), and parses
the collectives out of the compiled HLO; it runs in a subprocess, as
``tests/test_launch.py`` runs its multi-device checks, and the swap is a
monkeypatch there (no reference file changes).  The port's rules
(``repro_torch.roofline.analysis``) count the same meshes, given as
abstract meshes.  No bound holds one to the other: the rules describe the
port's pod runtime, whose measured traffic
``tests/test_torch_pod_runtime.py`` holds them to, and XLA partitions
differently.

    PYTHONPATH=src python tests/dryrun_collectives.py

prints the table (about 35 s on one CPU core, the reference's XLA compiles
most of it; too long for the tier-1 run, so it is no test).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"train_64": InputShape("train_64", 64, 32, "train"),
          "prefill_64": InputShape("prefill_64", 64, 32, "prefill")}
HOST_MESHES = {False: ((2, 4), ("data", "model")),
               True: ((2, 2, 2), ("pod", "data", "model"))}
CASES = [("train_64", "single"), ("train_64", "multi"),
         ("prefill_64", "single")]

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs.base import InputShape
from repro.configs.registry import get_config
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh

meshes, shapes, cases = json.loads(sys.argv[1])
dryrun.make_production_mesh = lambda multi_pod=False: make_host_mesh(
    *meshes[str(multi_pod).lower()])
dryrun.get_config = lambda arch: get_config(arch, smoke=True)
dryrun.INPUT_SHAPES = {k: InputShape(*v) for k, v in shapes.items()}
out = {}
for shape, mesh in cases:
    rec = dryrun.run_one("glm4-9b", shape, mesh)
    out[f"{shape} {mesh}"] = rec["collectives"]
print(json.dumps(out))
"""


def reference_collectives() -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.join(HERE, "..", "src")}
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([{"false": HOST_MESHES[False], "true": HOST_MESHES[True]},
                      {k: list(v.__dict__.values()) for k, v in SHAPES.items()},
                      CASES])
    r = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def port_collectives() -> dict:
    prev = dryrun.make_production_mesh
    dryrun.make_production_mesh = lambda multi_pod=False: AbstractMesh(
        HOST_MESHES[multi_pod][1],
        dict(zip(HOST_MESHES[multi_pod][1], HOST_MESHES[multi_pod][0])))
    try:
        return {f"{shape} {mesh}": dryrun.run_one(
            "glm4-9b", SHAPES[shape], mesh, smoke=True)["collectives"]
            for shape, mesh in CASES}
    finally:
        dryrun.make_production_mesh = prev


def table(ref: dict, port: dict) -> str:
    lines = ["| record | kind | reference bytes (count) | port bytes (count) |",
             "| --- | --- | --- | --- |"]
    for case in ref:
        kinds = sorted(set(ref[case]["bytes"]) | set(port[case]["bytes"]))
        for kind in kinds:
            cells = [f"{c['bytes'].get(kind, 0)} ({c['count'].get(kind, 0)})"
                     for c in (ref[case], port[case])]
            lines.append(f"| {case} | {kind} | {cells[0]} | {cells[1]} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(table(reference_collectives(), port_collectives()))
