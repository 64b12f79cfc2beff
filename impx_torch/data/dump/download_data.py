"""Chunked raw-dataset downloader (impx/data/dump/download_data.py; reference
dump/download_data.sh twin).

The YFCC/SUN3D raw archives used by the eval dumpers are published as
numbered tar chunks (`<name>.tar.000`, `.tar.001`, ...) on the OANet data
mirror. The reference ships a bash helper that wgets a chunk range and
concatenates the pieces; this is the same protocol as a Python CLI with
resume (skips chunks already fully on disk is not knowable without
Content-Length, so partially-downloaded chunks are re-fetched whole) and a
--dry-run mode that only prints the chunk URLs (this container has no
network egress — use --dry-run to produce a fetch list for another host).

Usage (mirrors the reference's positional-arg contract):
  python -m impx_torch.data.dump.download_data raw_data_yfcc raw_data/yfcc.tar \
      --chunk-start 0 --chunk-end 7
  cat is not needed afterwards: chunks are concatenated into the output
  path automatically, then the per-chunk files are removed.

Reference: dump/download_data.sh (chunk URL scheme
research.altizure.com/data/oanet_data/<file>.tar.<iii>).
"""
from __future__ import annotations

import argparse
import os
import sys
import urllib.request

MIRROR = "http://research.altizure.com/data"
DATASET = "oanet_data"


def chunk_urls(file_name: str, start: int, end: int,
               mirror: str = MIRROR, dataset: str = DATASET) -> list[str]:
    return [f"{mirror}/{dataset}/{file_name}.tar.{i:03d}"
            for i in range(start, end + 1)]


def fetch(url: str, dest: str, blocksize: int = 1 << 20,
          timeout: float = 60.0, retries: int = 3) -> None:
    """Fetch one chunk with a socket timeout and bounded per-chunk retries.

    The mirror protocol is plain HTTP with no published checksums (same as
    the reference's download_data.sh), so integrity is only guarded by the
    tar extraction step downstream.
    """
    last_err: Exception | None = None
    for attempt in range(retries):
        tmp = dest + ".part"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, \
                    open(tmp, "wb") as f:
                while True:
                    block = r.read(blocksize)
                    if not block:
                        break
                    f.write(block)
            os.replace(tmp, dest)
            return
        except OSError as e:  # covers socket timeouts + HTTP/URL errors
            last_err = e
            print(f"[download] {url}: attempt {attempt + 1}/{retries} "
                  f"failed ({e})", file=sys.stderr)
    raise RuntimeError(f"failed to fetch {url} after {retries} attempts") \
        from last_err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("file_name", help="archive base name on the mirror "
                                      "(e.g. raw_data_yfcc)")
    ap.add_argument("output", help="concatenated .tar output path")
    ap.add_argument("--chunk-start", type=int, default=0)
    ap.add_argument("--chunk-end", type=int, required=True)
    ap.add_argument("--mirror", default=MIRROR)
    ap.add_argument("--dataset", default=DATASET)
    ap.add_argument("--dry-run", action="store_true",
                    help="print chunk URLs and exit (no network)")
    args = ap.parse_args(argv)

    urls = chunk_urls(args.file_name, args.chunk_start, args.chunk_end,
                      args.mirror, args.dataset)
    if args.dry_run:
        for u in urls:
            print(u)
        return

    workdir = args.output + ".chunks"
    os.makedirs(workdir, exist_ok=True)
    paths = []
    for u in urls:
        dest = os.path.join(workdir, os.path.basename(u))
        if os.path.isfile(dest):
            print(f"[download] keep {dest}", file=sys.stderr)
        else:
            print(f"[download] {u}", file=sys.stderr)
            fetch(u, dest)
        paths.append(dest)

    with open(args.output, "wb") as out:
        for p in paths:
            with open(p, "rb") as f:
                while True:
                    block = f.read(1 << 20)
                    if not block:
                        break
                    out.write(block)
    for p in paths:
        os.remove(p)
    os.rmdir(workdir)
    print(f"[download] wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
