"""Host memory of reading a large safetensors file one tensor at a time.

Writes a 3 GB bf16 safetensors file (90 tensors of 4096 x 4096) into a
temporary directory, then reads every tensor and moves it to the device
twice, printing the process's resident set before and its peak during
each read:

- through ``models/hf_io.py`` (positional reads of each tensor's bytes);
- through a private mapping of the file, each tensor copied out and its
  pages handed back with ``madvise(MADV_DONTNEED)``.

Run from the root of a checkout (one GPU, or the CPU without one)::

    python3 scripts/hf_read_rss.py
"""

from __future__ import annotations

import json
import mmap
import os
import shutil
import struct
import sys
import tempfile
import threading

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vietnamese_qa_system_tpu_torch.models.hf_io import Checkpoint  # noqa: E402

N, SHAPE = 90, (4096, 4096)


def rss() -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


def peak_while(fn) -> int:
    peak, stop = [rss()], threading.Event()

    def sample():
        while not stop.wait(0.01):
            peak[0] = max(peak[0], rss())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        fn()
    finally:
        stop.set()
        th.join()
    return max(peak[0], rss())


def main() -> int:
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    torch.zeros(1, device=dev)
    d = tempfile.mkdtemp(prefix="hf_read_rss_")
    try:
        n_bytes = 2 * SHAPE[0] * SHAPE[1]
        header = {f"t{i}": {"dtype": "BF16", "shape": list(SHAPE), "data_offsets": [i * n_bytes, (i + 1) * n_bytes]}
                  for i in range(N)}
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        path = os.path.join(d, "model.safetensors")
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw)
            for _ in range(N):
                t = torch.randn(SHAPE, device=dev).to(torch.bfloat16).cpu()
                f.write(memoryview(t.view(torch.uint8).numpy()))
        print(f"device {torch.cuda.get_device_name(0) if dev == 'cuda' else 'cpu'}; file {N * n_bytes / 1e9:.2f} GB",
              flush=True)

        def pread_reader():
            with Checkpoint(d) as ck:
                for name in ck:
                    ck[name].to(dev)

        def mapped_reader():
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            base = 8 + len(raw)
            for e in header.values():
                start, end = (base + o for o in e["data_offsets"])
                torch.frombuffer(mm, dtype=torch.uint8, count=end - start, offset=start).clone().to(dev)
                lo = start // mmap.PAGESIZE * mmap.PAGESIZE
                mm.madvise(mmap.MADV_DONTNEED, lo, end - lo)
            mm.close()

        for label, fn in (("hf_io (positional reads)", pread_reader), ("mapped + MADV_DONTNEED", mapped_reader)):
            before = rss()
            peak = peak_while(fn)
            print(f"{label}: RSS before {before / 1e9:.3f} GB, peak while reading {peak / 1e9:.3f} GB "
                  f"(+{(peak - before) / 1e9:.3f} GB)", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
