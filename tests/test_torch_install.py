"""The port runs from its installed wheel as it runs from the checkout.

One wheel is built (offline, ``pip wheel --no-deps --no-build-isolation``)
from a copy of the image's build context (``pyproject.toml``,
``README.md``, ``tf_operator_tpu_torch``) and installed with ``--target``
into a directory made read-only. Each check runs in a subprocess whose
working directory lies outside the checkout, with that directory as the
only ``PYTHONPATH`` and a fresh ``HOME`` and ``XDG_CACHE_HOME``: what the
port builds at run time (the native helpers with g++ on the CPU; the
kernels with nvcc on the card, ``chip_smoke.py`` phase ``installed``) must
land in the cache. The operator image (``build/images/tpu_operator_torch``)
is checked statically: these tests run no Docker.
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap
import tomllib
import zipfile

import numpy as np
import pytest

from tf_operator_tpu import native as jnative
from tf_operator_tpu_torch import native as tnative
from tf_operator_tpu_torch import testutil
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.e2e

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "tf_operator_tpu_torch"
DOCKERFILE = REPO / "build" / "images" / "tpu_operator_torch" / "Dockerfile"
# The image's build context: what the wheel is built from.
CONTEXT = ("pyproject.toml", "README.md", PACKAGE)
PIP = (sys.executable, "-m", "pip", "--disable-pip-version-check")


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """(the wheel's path, the read-only --target install)."""
    work = tmp_path_factory.mktemp("wheel")
    src = work / "src"
    src.mkdir()
    for name in CONTEXT:
        if (REPO / name).is_dir():
            shutil.copytree(REPO / name, src / name,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(REPO / name, src)
    subprocess.run([*PIP, "wheel", "--no-deps", "--no-build-isolation",
                    "--no-index", "--wheel-dir", str(work / "dist"),
                    str(src)], cwd=work, check=True, capture_output=True,
                   timeout=300)
    (whl,) = (work / "dist").glob("*.whl")
    site = work / "site"
    subprocess.run([*PIP, "install", "--no-deps", "--no-index", "--target",
                    str(site), str(whl)], cwd=work, check=True,
                   capture_output=True, timeout=300)
    subprocess.run(["chmod", "-R", "a-w", str(site)], check=True)
    yield whl, site
    subprocess.run(["chmod", "-R", "u+w", str(work)], check=True)


def installed(site, tmp_path, code, *args, blocked=()):
    """Run ``code`` in a fresh process against the install alone: the
    checkout off ``sys.path``, a fresh HOME and XDG_CACHE_HOME under
    ``tmp_path``, ``blocked`` modules refused. Returns (the process, the
    cache)."""
    run, home = tmp_path / "run", tmp_path / "home"
    run.mkdir()
    home.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(site), HOME=str(home),
               XDG_CACHE_HOME=str(home / "cache"))
    prologue = textwrap.dedent(f"""
        import sys
        BLOCKED = {tuple(blocked)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".")
                       for b in BLOCKED):
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
    """)
    proc = subprocess.run([sys.executable, "-c", prologue + code, *args],
                          cwd=run, env=env, capture_output=True, text=True,
                          timeout=120)
    return proc, home / "cache" / PACKAGE


def sources_the_loaders_read():
    """Every file the port's two build loaders read, relative to the
    package: ops/_build.py's sources of each kernel library and every
    native/<name>.cc."""
    root = pathlib.Path(fa.__file__).resolve().parents[1]
    files = {f for name in fa._LIBRARY.values()
             for f in _build._sources(name)[1]}
    files |= set(tnative.SRC.glob("*.cc"))
    return sorted(str(f.relative_to(root.parent)) for f in files)


def test_wheel_holds_every_source_the_port_builds(wheel):
    whl, _ = wheel
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
    wanted = sources_the_loaders_read()
    assert {f"{PACKAGE}/native/batchgen.cc",
            f"{PACKAGE}/native/loader.cc",
            f"{PACKAGE}/csrc/flash_attention.cu"} <= set(wanted)
    missing = [f for f in wanted if f not in names]
    assert not missing, f"the wheel lacks {missing}"


def test_wheel_holds_the_job_catalogue(wheel):
    """Every catalogue file, examples/<dir>/<file>.yaml, and its README
    are in the wheel, byte for byte."""
    whl, _ = wheel
    root = REPO / PACKAGE / "examples"
    wanted = sorted([root / "README.md", *root.glob("*/*.yaml")])
    assert len(wanted) == 15
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
        for path in wanted:
            name = str(path.relative_to(REPO))
            assert name in names, f"the wheel lacks {name}"
            assert z.read(name) == path.read_bytes(), name


def test_run_local_runs_the_installed_catalogue(wheel, tmp_path):
    """The smoke file the install carries, as it stands (it pins the
    CPU), through run_local from the read-only install."""
    _, site = wheel
    smoke = site / PACKAGE / "examples" / "smoke" / "tpujob_smoke.yaml"
    proc, _ = installed(site, tmp_path, """
import runpy
sys.argv[1:] = [sys.argv[1], "--timeout", "60"]
runpy.run_module("tf_operator_tpu_torch.run_local", run_name="__main__",
                 alter_sys=True)
""", str(smoke))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TPUJob tpu-smoke: Succeeded" in proc.stdout
    assert f"port imported from {site / PACKAGE}" in proc.stdout
    assert proc.stdout.rstrip().endswith("smoke OK on 1 device(s)")


def test_native_helpers_build_into_the_cache(wheel, tmp_path):
    """From the read-only install the native generator builds with g++
    into the per-user cache (0700) and gives the JAX package's bytes."""
    _, site = wheel
    proc, cache = installed(site, tmp_path, textwrap.dedent("""
        import json, numpy as np
        import tf_operator_tpu_torch
        from tf_operator_tpu_torch import native
        from tf_operator_tpu_torch.ops import _build
        np.save("uniform.npy", native.fill_uniform((3, 1 << 16), 11))
        np.save("randint.npy", native.fill_randint((2, 40), -5, 100, 7))
        print(json.dumps({
            "package": tf_operator_tpu_torch.__file__,
            "native": str(native.library_path("batchgen")),
            "kernels": str(_build.library_path("flash_attention"))}))
    """))
    assert proc.returncode == 0, proc.stderr
    paths = json.loads(proc.stdout.splitlines()[-1])
    assert pathlib.Path(paths["package"]).is_relative_to(site)
    for key in ("native", "kernels"):
        assert pathlib.Path(paths[key]).is_relative_to(cache), paths
    assert pathlib.Path(paths["native"]).exists()
    assert (cache.stat().st_mode & 0o777) == 0o700
    assert ((cache / "torch_native").stat().st_mode & 0o777) == 0o700
    run = tmp_path / "run"
    assert np.load(run / "uniform.npy").tobytes() == jnative.fill_uniform(
        (3, 1 << 16), 11).tobytes()
    assert np.load(run / "randint.npy").tobytes() == jnative.fill_randint(
        (2, 40), -5, 100, 7).tobytes()


@pytest.mark.parametrize("command", ["version", "console_script"])
def test_installed_entry_points_start_without_torch(wheel, tmp_path,
                                                    command):
    """``python -m tf_operator_tpu_torch --version`` and the installed
    ``tpu-operator-torch --help`` with torch, JAX and the JAX package
    blocked, as tests/test_torch_import.py blocks them."""
    _, site = wheel
    run = {"version": """
import runpy
sys.argv[1:] = ["--version"]
runpy.run_module("tf_operator_tpu_torch", run_name="__main__",
                 alter_sys=True)
""", "console_script": f"""
import runpy
sys.argv[1:] = ["--help"]
runpy.run_path({str(site / "bin" / "tpu-operator-torch")!r},
               run_name="__main__")
"""}[command]
    proc, _ = installed(site, tmp_path, run, blocked=(
        "torch", "jax", "flax", "optax", "orbax", "tf_operator_tpu"))
    assert proc.returncode == 0, proc.stderr
    if command == "version":
        assert proc.stdout.startswith("tpu-operator-torch v"), proc.stdout
    else:
        assert "--backend" in proc.stdout and "--api-port" in proc.stdout


def test_run_local_runs_pods_under_the_cache(wheel, tmp_path):
    """run_local from the install: pods run in a fresh directory under
    the cache, never in site-packages, and import the install."""
    _, site = wheel
    job = tmp_path / "job.json"
    job.write_text(json.dumps(testutil.new_tpujob(
        worker=1, name="installed-smoke", command=[
            sys.executable, "-m", "tf_operator_tpu_torch.train.gpu_smoke",
            "--device", "cpu"]).to_dict()))
    proc, cache = installed(site, tmp_path, """
import runpy
sys.argv[1:] = [sys.argv[1], "--timeout", "60"]
runpy.run_module("tf_operator_tpu_torch.run_local", run_name="__main__",
                 alter_sys=True)
""", str(job))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    workdir = re.search(r"pods run in (\S+)", proc.stdout)[1]
    assert pathlib.Path(workdir).parent == cache, workdir
    assert "TPUJob installed-smoke: Succeeded" in proc.stdout
    assert f"port imported from {site / PACKAGE}" in proc.stdout


def test_a_checkout_builds_under_its_build_directory():
    """From the checkout nothing moved: build/torch_kernels/ and
    build/torch_native/ of the repo."""
    from tf_operator_tpu_torch import _paths

    assert _paths.checkout_root() == REPO
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"
    assert tnative.BUILD_DIR == REPO / "build" / "torch_native"
    assert _paths.base_dir() == REPO / "build"


def dockerfile():
    """(instructions as (keyword, argument) pairs, the header's tag)."""
    text = DOCKERFILE.read_text()
    tag = re.search(r"^#\s+docker build .* -t (\S+) \.$", text, re.M)[1]
    lines = re.sub(r"\\\n", " ", text).splitlines()
    steps = [tuple(line.split(None, 1)) for line in lines
             if line.strip() and not line.lstrip().startswith("#")]
    return steps, tag


def test_operator_image():
    steps, tag = dockerfile()
    copies = [arg.split() for kw, arg in steps if kw == "COPY"]
    sources = [src for args in copies if not args[0].startswith("--from")
               for src in args[:-1]]
    assert sorted(sources) == sorted(CONTEXT)
    assert all((REPO / src).exists() for src in sources)
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    (entry,) = [json.loads(arg) for kw, arg in steps if kw == "ENTRYPOINT"]
    assert scripts[entry[0]] == "tf_operator_tpu_torch.cli:main"
    installs = " ".join(arg for kw, arg in steps if kw == "RUN"
                        and "pip install" in arg)
    assert "--no-deps" in installs
    assert not re.search(r"\btorch\b", installs)
    assert ("USER", "1000") in steps
    images = [m[1] for f in sorted((REPO / "manifests" / "gpu").glob(
        "*.yaml")) for m in re.finditer(r"^\s*image:\s*(\S+)\s*$",
                                        f.read_text(), re.M)]
    assert images and set(images) == {tag}
