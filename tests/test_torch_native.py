"""The port's native library loader: processes that start together build
the library once, into the build directory they are given, and each
loads a whole file; nothing is written under ``native/``, where the JAX
package builds its own copy."""

import json
import os
import subprocess
import sys

import pytest

from pllmod_tpu_torch import native
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 4

# one process of the race: record every command the loader runs, load
# the library from the directory given, report what it got
_CHILD = """
import json, subprocess, sys
ran = []
real_run = subprocess.run
def run(cmd, *a, **k):
    ran.append(list(cmd))
    return real_run(cmd, *a, **k)
subprocess.run = run
from pllmod_tpu_torch import native
lib = native.load_library(sys.argv[1])
print(json.dumps({"loaded": lib is not None,
                  "path": native.library_path(sys.argv[1]),
                  "commands": ran}))
"""


@pytest.fixture(scope="module")
def race(tmp_path_factory):
    """N_PROCS processes load the library at once from an empty build
    directory: (the directory, each process's report)."""
    build_dir = str(tmp_path_factory.mktemp("native_build"))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, build_dir],
                              cwd=_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        reports.append(json.loads(out.strip().splitlines()[-1]))
    return build_dir, reports


def test_processes_racing_from_an_empty_directory_all_load(race):
    build_dir, reports = race
    assert [r["loaded"] for r in reports] == [True] * N_PROCS
    assert {r["path"] for r in reports} == {native.library_path(build_dir)}
    # the lock serializes the freshness check: one process compiles
    compiles = [c for r in reports for c in r["commands"]]
    assert len(compiles) == 1


def test_the_library_is_built_in_the_build_directory_only(race):
    build_dir, reports = race
    [cmd] = [c for r in reports for c in r["commands"]]
    target = cmd[cmd.index("-o") + 1]
    assert os.path.dirname(target) == build_dir
    assert not target.startswith(os.path.join(_ROOT, "native"))
    # the temporary file was moved into place; nothing else is left
    assert sorted(os.listdir(build_dir)) == sorted([
        os.path.basename(native.library_path(build_dir)),
        "pllmod_native.lock"])


def test_default_library_lies_under_build():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(_ROOT, "build")
    assert native.BUILD_DIR == os.path.join(_ROOT, "build")
    assert native.available()
