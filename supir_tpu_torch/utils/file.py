"""File discovery and the cached-download helper (counterpart of
supir_tpu/utils/file.py; behavioural contract SUPIR/utils/file.py):
file lists, recursive image discovery with an extension filter and an
early stop, and "download once into a cache dir, keyed by the URL's
basename" (`load_file_from_url:50`). The cache is $SUPIR_CACHE_DIR
(default ~/.cache/supir_tpu/checkpoints); with SUPIR_OFFLINE=1 a file
not yet in the cache raises instead of being fetched.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple
from urllib.parse import urlparse


def load_file_list(file_list_path: str) -> List[str]:
    """One image path per non-empty line (SUPIR/utils/file.py:8-17)."""
    with open(file_list_path, "r") as fin:
        return [line.strip() for line in fin if line.strip()]


def list_image_files(img_dir: str, exts: Tuple[str, ...] = (".jpg", ".png", ".jpeg"), follow_links: bool = False,
                     log_progress: bool = False, log_every_n_files: int = 10000, max_size: int = -1) -> List[str]:
    """Recursive extension-filtered walk with an optional size cap
    (SUPIR/utils/file.py:20-41)."""
    files: List[str] = []
    for dir_path, _, file_names in os.walk(img_dir, followlinks=follow_links):
        early_stop = False
        for file_name in file_names:
            if os.path.splitext(file_name)[1].lower() in exts:
                if 0 <= max_size <= len(files):
                    early_stop = True
                    break
                files.append(os.path.join(dir_path, file_name))
                if log_progress and len(files) % log_every_n_files == 0:
                    print(f"find {len(files)} images in {img_dir}")
        if early_stop:
            break
    return files


def get_cache_dir() -> str:
    return os.environ.get("SUPIR_CACHE_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache", "supir_tpu", "checkpoints"))


def load_file_from_url(url: str, model_dir: Optional[str] = None, file_name: Optional[str] = None) -> str:
    """A local path for `url`: the cached file where it exists, else
    downloaded into the cache (SUPIR/utils/file.py:50-66), or
    FileNotFoundError naming the expected path when SUPIR_OFFLINE=1."""
    model_dir = model_dir or get_cache_dir()
    os.makedirs(model_dir, exist_ok=True)
    name = file_name or os.path.basename(urlparse(url).path)
    cached = os.path.abspath(os.path.join(model_dir, name))
    if os.path.exists(cached):
        return cached
    if os.environ.get("SUPIR_OFFLINE", "0") == "1":
        raise FileNotFoundError(f"offline mode: place {url} at {cached} (SUPIR_OFFLINE=1)")
    import urllib.request

    print(f'Downloading: "{url}" to {cached}')
    tmp = cached + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, cached)
    return cached
