"""The GPU-facing entry points as far as the CPU can check them: the compile
cache's placement, ``chip_smoke.py`` and ``bench.py`` refusing to run
without a GPU, the smoke script's last line, and the multi-device dryrun's
device count."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, cwd=REPO, **env):
    full = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    full.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    full.update(env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


CACHE_PROBE = ("import os, aegis_tpu, jax; "
               "print(os.environ['JAX_COMPILATION_CACHE_DIR']); "
               "print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(env_dir, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache —
    never a temp name, a pid or a time."""
    env = {} if env_dir is None else {
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / env_dir)}
    r = _python(["-c", CACHE_PROBE], **env)
    assert r.returncode == 0, r.stderr
    want = (os.path.join(REPO, ".jax_cache") if env_dir is None
            else str(tmp_path / env_dir))
    assert r.stdout.split() == [want, want]
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


def test_chip_smoke_refuses_cpu():
    r = _python(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the program, the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _python(["chip_smoke.py"], cwd=str(tmp_path), PYTHONPATH="")
    assert r.returncode != 0 and '"ok"' not in r.stdout


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("four", [False, True])
def test_chip_smoke_last_line(four, monkeypatch):
    """Every phase passing -> the last stdout line is exactly the record the
    driver reads; with --four-cards only phase 7 runs."""
    import jax

    sys.path.insert(0, REPO)
    import chip_smoke

    ran = []
    for name in ("viterbi_parity", "f1_gates", "served", "neural",
                 "long_track", "four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda name=name: ran.append(name) or {"ok": True})
    count = 4 if four else 1
    monkeypatch.setattr(jax, "devices", lambda: [_FakeGpu()] * count)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, "H100, 700 W\n", ""))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = chip_smoke.main(["--four-cards"] if four else [])
    lines = out.getvalue().strip().splitlines()
    assert rc == 0 and lines[0] == "H100, 700 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert ran == (["four_cards"] if four else
                   ["viterbi_parity", "f1_gates", "served", "neural",
                    "long_track"])


def test_chip_smoke_stops_at_failed_phase(monkeypatch):
    import jax

    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "viterbi_parity", lambda: {"ok": False})
    monkeypatch.setattr(jax, "devices", lambda: [_FakeGpu()])
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, "H100, 700 W\n", ""))
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok": true' not in out.getvalue().splitlines()[-1]


def test_bench_refuses_cpu():
    r = _python(["bench.py"])
    assert r.returncode != 0 and "needs a GPU" in r.stderr
    assert "realtime_factor" not in r.stdout


def test_dryrun_needs_the_devices_it_names():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        __graft_entry__.dryrun_multichip(64)
