"""Platform handling: the kernel choice, no silent fallbacks, the compile
cache location, and the on-card scripts refusing to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from barbell_tpu.ops import kernels as kern  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.mark.parametrize(
    "platform,want",
    [("cpu", kern.XLA), ("gpu", kern.GPU), ("rocm", None)],
)
def test_kernels_for_platform(platform, want):
    if want is None:
        with pytest.raises(ValueError, match="rocm"):
            kern.for_platform(platform)
    else:
        assert kern.for_platform(platform) == want


def test_compiled_kernels_need_a_gpu():
    kern.check_platform(kern.GPU, "gpu")
    kern.check_platform(kern.INTERPRET, "cpu")
    kern.check_platform(kern.XLA, "cpu")
    with pytest.raises(ValueError, match="need a GPU"):
        kern.check_platform(kern.Kernels(rank=True), "cpu")
    assert kern.GPU.compiled and not kern.INTERPRET.compiled


def _groups():
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    groups = BarcodeGroup.from_kit("SQK-RBK114-24")
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def test_engine_kernel_choice_on_cpu():
    """The CPU engine runs the jnp twins by default, the interpreter
    only when asked, and refuses compiled Triton kernels."""
    from barbell_tpu.models.pipeline import JaxDemuxEngine

    cpu1 = jax.devices()[:1]
    assert JaxDemuxEngine(_groups(), devices=cpu1).kernels == kern.XLA
    assert (
        JaxDemuxEngine(_groups(), devices=cpu1, kernels=kern.INTERPRET).kernels
        == kern.INTERPRET
    )
    with pytest.raises(ValueError, match="need a GPU"):
        JaxDemuxEngine(_groups(), devices=cpu1, kernels=kern.GPU)


def test_backend_auto_raises_instead_of_falling_back(monkeypatch):
    """``--backend auto`` is the device engine: a failure to build it
    surfaces, it never turns into a scalar-oracle run."""
    from barbell_tpu.stages import annotate

    def broken(groups, config):
        raise RuntimeError("device engine unavailable")

    monkeypatch.setattr(annotate, "_jax_engine", broken)
    cfg = annotate.AnnotateConfig(backend="auto")
    with pytest.raises(RuntimeError, match="unavailable"):
        annotate._make_engine(_groups(), cfg)
    oracle = annotate._make_engine(_groups(), annotate.AnnotateConfig(backend="oracle"))
    assert isinstance(oracle, annotate._OracleEngine)


_CACHE_PROBE = (
    "import jax\n"
    "from barbell_tpu.utils import jaxcache\n"
    "jaxcache.enable_compilation_cache()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_jaxcache_defaults_to_the_checkout():
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("BARBELL_JAX_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want
    assert os.path.isdir(want)
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_jaxcache_honours_the_env_var(tmp_path):
    env = _cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    env.pop("BARBELL_JAX_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "cc")


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


def test_chip_smoke_fails_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_cpu_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert _no_result(out.stdout)
    assert "not a GPU" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert _no_result(out.stdout)


def test_bench_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO,
        env=_cpu_env(BENCH_READS="64", BENCH_BATCH="64"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    assert _no_result(out.stdout) and '"value"' not in out.stdout
    assert "no GPU" in out.stderr
