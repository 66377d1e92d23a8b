"""The port's loader of the native host library (``native/``).

Importing this module builds the library when it is missing, through the
port's loader: under an exclusive lock, into a temporary name renamed onto
``native/libpm_native.so``.  Test workers import every test file before
they run any test, so the library on disk is whole before a test of the
reference, whose own loader runs ``make`` in place when the file is
missing, can look for it.  A failed build leaves ``load()`` at None and
changes nothing that is collected.
"""
import os
import shutil
import subprocess
import sys

from paramugsy_tpu_torch.ops import native as port_native

port_native.load()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOAD_IN = r"""
import os, sys
from paramugsy_tpu_torch.ops import native
native._NATIVE_DIR = sys.argv[1]
native._LIB_PATH = os.path.join(sys.argv[1], "libpm_native.so")
native._LOCK_PATH = os.path.join(sys.argv[1], "native.lock")
lib = native.load()
print(native._version_of(lib) if lib is not None else -1)
"""


def test_loader_builds_and_loads():
    lib = port_native.load()
    assert lib is not None
    assert port_native._version_of(lib) == port_native.PM_VERSION_EXPECTED
    assert os.path.exists(port_native._LIB_PATH)


def test_concurrent_first_loads_all_get_a_whole_library(tmp_path):
    """Six processes start together on a copy of native/ without its
    library: one builds it, the others wait on the lock and load the
    renamed result; none opens a half-written file."""
    src = tmp_path / "native"
    src.mkdir()
    for name in os.listdir(os.path.join(ROOT, "native")):
        if name == "Makefile" or name.endswith(".cc"):
            shutil.copy(os.path.join(ROOT, "native", name), src / name)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _LOAD_IN, str(src)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(port_native.PM_VERSION_EXPECTED)], (out, err)
    left = sorted(os.listdir(src))
    assert "libpm_native.so" in left
    assert not [n for n in left if n.endswith(".tmp.so")], left
