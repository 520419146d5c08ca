"""Where the persistent compile cache lands, and chip_smoke.py's refusal
to report success anywhere but on a GPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from yulio_raytracer.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path / 'c'))
    assert compile_cache.cache_dir() == str(tmp_path / 'c')


def test_cache_dir_default_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(ROOT, '.jax_cache')
    with open(os.path.join(ROOT, '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()


def test_enable_configures_jax_at_the_env_dir(monkeypatch, tmp_path):
    import jax
    old = jax.config.jax_compilation_cache_dir
    want = str(tmp_path / 'cache')
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update('jax_compilation_cache_dir', old)


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get('ok'):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT, os.path.join(ROOT, 'chip_smoke.py'))
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert 'no GPU' in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    r = _run_smoke(str(tmp_path), 'chip_smoke.py')
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert 'yulio_raytracer' in r.stderr


@pytest.mark.parametrize('argv', [['--four'], []])
def test_chip_smoke_options_parse(argv, monkeypatch):
    """The device phase runs first and refuses the CPU for either form."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    with pytest.raises(chip_smoke.SmokeFailure, match='no GPU'):
        chip_smoke.main(argv)
