"""What the training path needs of dcase2019_task4_tpu/data/features_cache.py:
`drop_missing_audio`. The on-disk feature cache and the `precompute`
command are not ported yet.
"""

from __future__ import annotations

import os

from dcase2019_task4_tpu_torch.data.manifests import manifest_from_rows
from dcase2019_task4_tpu_torch.utils.logger import get_logger


def drop_missing_audio(manifest, source, logger=None):
    """Drop manifest rows whose audio is unreadable, with an error log per
    file — the reference's tolerance behaviour
    (DatasetDcase2019Task4.py:254-262). Returns a filtered Manifest."""
    log = logger or get_logger()
    missing = []
    for name in manifest.filenames:
        try:
            if hasattr(source, "path_for"):
                if not os.path.isfile(source.path_for(name)):
                    raise FileNotFoundError(source.path_for(name))
            else:
                source.get_audio(name)
        except (FileNotFoundError, ValueError, OSError):
            log.error(f"File {name} is in the tsv file but the audio is not present!")
            missing.append(name)
    if not missing:
        return manifest
    gone = set(missing)
    return manifest_from_rows([r for r in manifest.rows if r["filename"] not in gone], manifest.columns)
