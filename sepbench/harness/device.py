"""What a run records of its process and its cards."""
from __future__ import annotations

import os
import subprocess
import time

_QUERY = ('name', 'power.limit', 'clocks.sm', 'clocks.max.sm',
          'clocks.mem', 'temperature.gpu')


def process_start():
    """The epoch second this process started (the kernel's record of
    it), or now if that cannot be read."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_ticks = int(fields[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith('btime'))
        return boot + start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def smi(index=0):
    """{query: value} from nvidia-smi for card ``index`` (empty when it
    cannot be run)."""
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--query-gpu={",".join(_QUERY)}',
             '--format=csv,noheader,nounits', '-i', str(index)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    values = [v.strip() for v in out.stdout.strip().splitlines()[0]
              .split(',')]
    return dict(zip(_QUERY, values))


def record(torch, count, peak_bytes, before, after):
    """The result line's ``device``: the fields the contract reads, and
    the card's power limit, clocks before and after the window, and the
    CUDA version."""
    return {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': count,
        'memory_peak_bytes': int(peak_bytes),
        'power_limit_w': before.get('power.limit'),
        'clocks_sm_mhz': [before.get('clocks.sm'), after.get('clocks.sm')],
        'clocks_max_sm_mhz': before.get('clocks.max.sm'),
        'clocks_mem_mhz': before.get('clocks.mem'),
        'temperature_c': [before.get('temperature.gpu'),
                          after.get('temperature.gpu')],
        'cuda': torch.version.cuda,
        'torch': torch.__version__,
    }


__all__ = ['process_start', 'smi', 'record']
