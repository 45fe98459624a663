"""Classification dataset sources of the six other benchmarks.

Counterpart of eventpretrain_tpu/data/cls_sources.py, item for item. Each
source yields ``(events_xytp float64 (N, 4), label int)`` and plugs into
``data.cls_pipeline.ClsPipeline``; ``sensor_hw`` is the sensor the
pipeline augments (and rasterises) at. The layouts are the reference
loaders':

* N-Caltech101: ``root/<class>/<class>_*.npy`` xytp rows, sensor 180x240.
* CIFAR10-DVS: ``root/<class>/*_<class>_*.npy`` xytp rows, sensor 128x128;
  the ECDP image's coordinate rescale to the input follows the stream
  augment, so it is ``ClsPipeline``'s (``rescale_to_input="ecdp"``).
* N-ImageNet: ``root/<class>/<class>_*.npz`` holding a structured
  ``event_data`` array with x/y/t/p fields, timestamps in microseconds
  (scaled to seconds here), sensor 480x640; rescaled to the input for
  every representation (``rescale_to_input="always"``).
* ES-ImageNet: ``root/<class>/<name>.npz`` with ``pos``/``neg`` (row, col,
  t) arrays and a label file of ``<name> a b ...`` lines whose (a, b)
  recentre the sample; cropped to rows and columns 16..240 (224x224); the
  class directories cut to the first ``num_classes``.
* DVS128 Gesture: ``root/<label>/<file>.npz`` with x/y/t/p arrays; the
  label is the directory's integer name, not its sorted position; sensor
  128x128, ECDP rescale.
* UCF101-DVS: ``root/<class>/*.mat`` with x/y/ts/pol columns, read with
  ``scipy.io.loadmat``; sensor 180x240, ECDP rescale.
"""

from __future__ import annotations

import os
import re

import numpy as np


class _ClassDirSource:
    """The ``root/<class>/<file>`` layout, each class's files sorted."""

    def __init__(self, root: str, num_classes: int | None = None):
        self.root = root
        self.classes = sorted(os.listdir(root))
        if num_classes is not None:
            self.classes = self.classes[:num_classes]
        self.files: list[tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            for name in sorted(os.listdir(os.path.join(root, cls))):
                self.files.append((os.path.join(root, cls, name), label))

    def __len__(self) -> int:
        return len(self.files)


class NCaltech101Source(_ClassDirSource):
    sensor_hw = (180, 240)

    def load(self, index: int):
        path, label = self.files[index]
        return np.load(path).astype(np.float64), label


class Cifar10DvsSource(_ClassDirSource):
    sensor_hw = (128, 128)

    def load(self, index: int):
        path, label = self.files[index]
        return np.load(path).astype(np.float64), label


class NImageNetSource(_ClassDirSource):
    sensor_hw = (480, 640)

    def load(self, index: int):
        path, label = self.files[index]
        raw = np.load(path)
        arr = (raw["event_data"] if "event_data" in getattr(raw, "files", [])
               else raw)
        events = np.vstack(
            [arr["x"], arr["y"], arr["t"], arr["p"]]).T.astype(np.float64)
        events[:, 2] = events[:, 2] / 1e6
        return events, label


class EsImageNetSource(_ClassDirSource):
    sensor_hw = (224, 224)

    def __init__(self, root: str, label_path: str,
                 num_classes: int | None = None):
        super().__init__(root, num_classes)
        self.offsets: dict[str, tuple[int, int]] = {}
        with open(label_path) as f:
            for line in f:
                parts = re.split(" ", line)
                self.offsets[parts[0]] = (int(parts[1]), int(parts[2]))

    def load(self, index: int):
        path, label = self.files[index]
        name = os.path.basename(path)
        data = np.load(path)
        pos = np.concatenate(
            [data["pos"], np.ones((len(data["pos"]), 1))], axis=-1)
        neg = np.concatenate(
            [data["neg"], np.zeros((len(data["neg"]), 1))], axis=-1)
        events = np.concatenate([pos, neg], axis=0)
        events = events[events[:, 2].argsort()]
        a, b = self.offsets[name]
        dx, dy = (254 - a) // 2, (254 - b) // 2
        # the files store (row, col): y takes dx, x takes dy
        y = events[:, 0] + dx
        x = events[:, 1] + dy
        t = events[:, 2] - 1
        p = events[:, 3]
        keep = (x >= 16) & (x < 240) & (y >= 16) & (y < 240)
        return (np.stack([x[keep] - 16, y[keep] - 16, t[keep], p[keep]],
                         axis=-1), label)


class Dvs128GestureSource(_ClassDirSource):
    sensor_hw = (128, 128)

    def __init__(self, root: str):
        super().__init__(root)
        # the label is the directory's integer name: '10' sorts before '2'
        self.files = [(path, int(os.path.basename(os.path.dirname(path))))
                      for path, _ in self.files]

    def load(self, index: int):
        path, label = self.files[index]
        data = np.load(path)
        events = np.stack([data["x"], data["y"], data["t"], data["p"]],
                          axis=-1).astype(np.float64)
        return events, label


class Ucf101DvsSource(_ClassDirSource):
    # the reference augments and rasterises at 180x240, not the DAVIS240's
    # native 240x320
    sensor_hw = (180, 240)

    def load(self, index: int):
        import scipy.io

        path, label = self.files[index]
        m = scipy.io.loadmat(path)
        events = np.concatenate([m["x"], m["y"], m["ts"], m["pol"]],
                                axis=-1).astype(np.float64)
        return events, label
