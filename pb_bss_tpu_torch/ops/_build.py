"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by hand with ``nvcc`` for Hopper (``sm_90a``) into a shared
library and loaded with ctypes. Nothing is built or loaded when a
module is imported: :func:`load` builds on first use. The library name
carries a hash of the sources, so an edited kernel is rebuilt and a
stale one never loaded. The build directory, ``_kernels/`` inside this
package, is listed in ``.gitignore``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ['CSRC', 'BUILD_DIR', 'KERNELS', 'SMEM_LIMIT', 'nvcc_command',
           'load', 'build_all']

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = CSRC.parent / '_kernels'
_HEADERS = ('jacobi.cuh', 'em_common.cuh', 'watson.cuh', 'bingham.cuh',
            'integration.cuh')
# bytes of shared memory one block may opt into on the H100 (sm_90), the
# budget of every kernel's shape gate
SMEM_LIMIT = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points of each kernel library: name -> (argtypes, restype)
KERNELS = {
    'em_loop': {
        'cacgmm_em_full_launch': (
            [_P] * 9 + [_I] * 8 + [_F, _F, _P], _I),
        'cacgmm_em_full_occupancy': ([_I] * 4, _I),
    },
    'gev': {
        'gev_launch': ([_P, _P, _P, _I, _I, _I, _P], _I),
    },
    'eigh': {
        'eigh_jacobi_launch': ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    },
    'em_stream': {
        'em_stream_launch': (
            [_P] * 10 + [_I] * 5 + [_L, _F, _P], _I),
        'em_stream_capacity': ([_I, _I], _I),
    },
    'em_step': {
        'em_fc_init_launch': (
            [_P] * 7 + [_I] * 5 + [_F, _P], _I),
        'em_fc_step_launch': (
            [_P] * 10 + [_I] * 6 + [_F, _F, _P], _I),
    },
    'em_estep': {
        'em_e_step_launch': ([_P] * 9 + [_I] * 4 + [_P], _I),
        'em_scatter_launch': ([_P] * 10 + [_I] * 4 + [_P], _I),
    },
    'cwmm_loop': {
        'cwmm_em_full_launch': (
            [_P] * 8 + [_I] * 7 + [_F, _F, _I, _F, _F, _P], _I),
    },
    'mm_stream': {
        'mm_stream_launch': ([_P] * 11 + [_I] * 7 + [_F, _P], _I),
    },
    'bingham': {
        'bingham_chord_launch': ([_P] * 3 + [_I] * 3 + [_F] * 3 + [_P], _I),
    },
    'cbmm_loop': {
        'cbmm_em_full_launch': (
            [_P] * 8 + [_I] * 10 + [_F] * 8 + [_P], _I),
    },
    'integration_em': {
        'integration_stats_launch': (
            [_P] * 13 + [_I] * 9 + [_F] * 3 + [_P], _I),
    },
    'integration_em_loop': {
        'integration_em_loop_launch': (
            [_P] * 11 + [_I] * 10 + [_F] * 6 + [_I, _F, _F, _I, _I, _P, _P],
            _I),
    },
}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    return str(pathlib.Path(home) / 'bin' / 'nvcc')


def _sources(name):
    return [CSRC / f'{name}.cu'] + [CSRC / h for h in _HEADERS]


def _library_path(name):
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


@functools.lru_cache(maxsize=None)
def _split_compile():
    """nvcc's option to compile the functions of one source in parallel
    (one thread per core), where this nvcc has it: the whole-fit and
    streamed EM kernels instantiate a template for every D in 1..16."""
    try:
        usage = subprocess.run([_nvcc(), '--help'], capture_output=True,
                               text=True).stdout
    except OSError:
        return ()
    return ('--split-compile=0',) if '--split-compile' in usage else ()


def nvcc_command(name, output=None):
    """The nvcc command that builds kernel ``name`` (not run here)."""
    if name not in KERNELS:
        raise KeyError(name)
    output = output or _library_path(name)
    return [
        _nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
        '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
        *_split_compile(), '-Xptxas', '-v', '-I', str(CSRC),
        '-o', str(output), str(CSRC / f'{name}.cu'),
    ]


def _build(name):
    path = _library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders
    # (e.g. a CLI subprocess) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        start = time.perf_counter()
        result = subprocess.run(
            nvcc_command(name, tmp), capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f'nvcc failed to build {name}:\n{result.stderr}')
        path.with_suffix('.log').write_text(
            f'nvcc took {time.perf_counter() - start:.1f} s\n'
            + result.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.lru_cache(maxsize=None)
def load(name):
    """Build (once) and load kernel library ``name`` with its C
    signatures declared."""
    lib = ctypes.CDLL(str(_build(name)))
    for fn, (argtypes, restype) in KERNELS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build_log(name):
    """The build's seconds and the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) of the last build of kernel
    ``name``."""
    return _library_path(name).with_suffix('.log').read_text()


def build_all():
    """Build every kernel (one nvcc per source, all at once) and load
    them; returns {name: library}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        for _ in pool.map(_build, KERNELS):
            pass
    return {name: load(name) for name in KERNELS}
