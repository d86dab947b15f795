"""Unstructured-directory → train/test split formatter.

Equivalent of the reference's LocalUnstructuredDataFormatter
(deeplearning4j-core/.../datasets/rearrange/LocalUnstructuredDataFormatter.java):
walk an unstructured data directory, derive each file's label either from
its parent DIRECTORY name or from the file NAME (the token between the
last '-' and the extension, e.g. ``img01-cat.jpg`` → ``cat``; the
reference's char-walk keeps the dot — dropped here), and copy everything
into ``<destination>/split/{train,test}/<label>/`` with a percent_train
split (test count = total - floor(total * percent_train), as the
reference computes it).
"""

from __future__ import annotations

import os
import random
import shutil
from typing import List, Optional


class LocalUnstructuredDataFormatter:
    """ref: LocalUnstructuredDataFormatter.java:29-187."""

    NAME = "name"
    DIRECTORY = "directory"

    def __init__(self, destination_root_dir: str, root_dir: str,
                 labeling_type: str = DIRECTORY,
                 percent_train: float = 0.8,
                 seed: Optional[int] = None):
        if labeling_type not in (self.NAME, self.DIRECTORY):
            raise ValueError(f"unknown labeling type {labeling_type!r}")
        self.root_dir = root_dir
        self.split_root = os.path.join(destination_root_dir, "split")
        if os.path.exists(self.split_root):
            # ref :60 "Train/test split already exists"
            raise RuntimeError("Train/test split already exists: "
                               + self.split_root)
        self.train_dir = os.path.join(self.split_root, "train")
        self.test_dir = os.path.join(self.split_root, "test")
        self.labeling_type = labeling_type
        self.percent_train = percent_train
        self.seed = seed
        self.num_examples_total = -1
        self.num_test_examples = -1
        self.num_examples_to_train_on = -1

    # -- labels ------------------------------------------------------------
    def get_path_label(self, path: str) -> str:
        """DIRECTORY labeling: parent directory name (ref getPathLabel)."""
        return os.path.basename(os.path.dirname(path))

    def get_name_label(self, path: str) -> str:
        """NAME labeling: token between the last '-' and the extension
        (ref getNameLabel; e.g. 'img01-cat.jpg' -> 'cat')."""
        base = os.path.basename(path)
        dot = base.rfind(".")
        if dot < 0:
            raise ValueError(f"no extension in {path!r}")
        dash = base.rfind("-", 0, dot)
        if dash < 0:
            raise ValueError(
                f"no '-' in {path!r}; a dash marks the label for NAME "
                "labeling")
        return base[dash + 1:dot]

    def _label(self, path: str) -> str:
        return (self.get_name_label(path) if self.labeling_type == self.NAME
                else self.get_path_label(path))

    # -- split -------------------------------------------------------------
    def _all_files(self) -> List[str]:
        out = []
        for d, _, names in os.walk(self.root_dir):
            out.extend(os.path.join(d, n) for n in names)
        return sorted(out)  # deterministic before the seeded shuffle

    def rearrange(self) -> None:
        """Copy every file under root_dir into
        split/{train,test}/<label>/ (ref rearrange :66-104)."""
        files = self._all_files()
        self.num_examples_total = len(files)
        self.num_examples_to_train_on = int(
            len(files) * self.percent_train)
        self.num_test_examples = len(files) - self.num_examples_to_train_on
        random.Random(self.seed).shuffle(files)
        for i, path in enumerate(files):
            train = i < self.num_examples_to_train_on
            dst_root = self.train_dir if train else self.test_dir
            dst_dir = os.path.join(dst_root, self._label(path))
            os.makedirs(dst_dir, exist_ok=True)
            dst = os.path.join(dst_dir, os.path.basename(path))
            # colliding basenames (same label from different subdirs) must
            # not silently overwrite — the split would shrink below the
            # reported counts
            n = 1
            while os.path.exists(dst):
                stem, ext = os.path.splitext(os.path.basename(path))
                dst = os.path.join(dst_dir, f"{stem}__{n}{ext}")
                n += 1
            shutil.copy2(path, dst)

    def get_new_destination(self, path: str, train: bool) -> str:
        """Destination path a file would be copied to (ref
        getNewDestination :110-146)."""
        root = self.train_dir if train else self.test_dir
        return os.path.join(root, self._label(path),
                            os.path.basename(path))

    # ref getter names
    def get_num_examples_total(self) -> int:
        return self.num_examples_total

    def get_num_examples_to_train_on(self) -> int:
        return self.num_examples_to_train_on

    def get_num_test_examples(self) -> int:
        return self.num_test_examples
