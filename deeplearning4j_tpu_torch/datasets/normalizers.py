"""Data normalizers: fit statistics on a dataset, transform / revert
batches, and embed them in model archives.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py``, the same
numpy code and JSON form (``to_json``, ``normalizer_from_dict``), so a
normalizer either package wrote restores in the other
(``util/model_serializer.py``); the fused uint8 NHWC pack is
``datasets/host_io.py``'s ``u8hwc_to_f32chw``.

Equivalent of ND4J's DataNormalization family as DL4J uses it
(NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler;
ModelSerializer.addNormalizerToModel embeds the fitted normalizer in the
checkpoint zip so inference applies identical preprocessing —
util/ModelSerializer.java `addNormalizerToModel`/`restoreNormalizerFromFile`).

All three fit per-feature statistics over a DataSetIterator or arrays,
`transform` in place on DataSet objects or return-by-value on arrays, and
`revert_features`/`revert_labels` invert them. JSON serialization keeps
the checkpoint embed format human-readable.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.host_io import u8hwc_to_f32chw

NORMALIZER_REGISTRY: Dict[str, type] = {}


def register_normalizer(cls):
    NORMALIZER_REGISTRY[cls.__name__] = cls
    return cls


def normalizer_from_dict(d: dict):
    d = dict(d)
    cls = NORMALIZER_REGISTRY[d.pop("@class")]
    return cls._from_dict(d)


def _feature_axes(x: np.ndarray):
    """Reduce over all axes except the feature axis: axis 1 for [N,F],
    [N,C,H,W] and [N,C,T] alike (DL4J stats are per-feature/channel)."""
    return tuple(i for i in range(x.ndim) if i != 1)


def _bshape(x: np.ndarray, v: np.ndarray):
    shape = [1] * x.ndim
    shape[1] = v.shape[0]
    return v.reshape(shape)



def _is_u8_nhwc(x: np.ndarray) -> bool:
    """Unambiguous uint8 NHWC decode-order batch? (channel-minor count in
    {1,3,4} while axis 1 is clearly spatial)."""
    return (x.dtype == np.uint8 and x.ndim == 4
            and x.shape[-1] in (1, 3, 4) and x.shape[1] not in (1, 3, 4))


class _BaseNormalizer:
    """fit / transform / revert protocol (ref: DataNormalization)."""

    fit_labels_flag = False

    def fit_label(self, enable: bool = True) -> None:
        """ref: DataNormalization.fitLabel — also normalize labels."""
        self.fit_labels_flag = enable

    # -- fitting -----------------------------------------------------------
    def fit(self, data) -> "_BaseNormalizer":
        """Accepts a DataSet, a DataSetIterator, or a features array."""
        if isinstance(data, DataSet):
            self._fit_arrays(np.asarray(data.features),
                             None if data.labels is None
                             else np.asarray(data.labels))
        elif hasattr(data, "__iter__") and not hasattr(data, "shape"):
            feats, labs = [], []
            for ds in data:
                feats.append(np.asarray(ds.features))
                if self.fit_labels_flag and ds.labels is not None:
                    labs.append(np.asarray(ds.labels))
            if hasattr(data, "reset"):
                data.reset()
            self._fit_arrays(np.concatenate(feats),
                             np.concatenate(labs) if labs else None)
        else:
            self._fit_arrays(np.asarray(data), None)
        return self

    def _fit_arrays(self, x, y):
        raise NotImplementedError

    # -- application -------------------------------------------------------
    def transform(self, data):
        """DataSet -> normalized in place (reference semantics);
        array -> normalized copy returned."""
        if isinstance(data, DataSet):
            data.features = self._tx(np.asarray(data.features),
                                     *self._feature_stats())
            if self.fit_labels_flag and data.labels is not None:
                data.labels = self._tx(np.asarray(data.labels),
                                       *self._label_stats_checked())
            return data
        return self._tx(np.asarray(data), *self._feature_stats())

    preprocess = transform  # DataNormalization.preProcess alias

    def revert_features(self, x) -> np.ndarray:
        return self._inv(np.asarray(x), *self._feature_stats())

    def revert_labels(self, y) -> np.ndarray:
        if not self.fit_labels_flag:
            return np.asarray(y)
        return self._inv(np.asarray(y), *self._label_stats_checked())

    def _label_stats_checked(self):
        stats = self._label_stats()
        if any(v is None for v in stats):
            raise RuntimeError(
                "fit_label(True) is set but label statistics were never "
                "fitted — fit() must see labeled DataSets")
        return stats

    # -- serde -------------------------------------------------------------
    def to_json(self) -> str:
        d = {"@class": type(self).__name__,
             "fitLabels": self.fit_labels_flag}
        d.update(self._stats_dict())
        return json.dumps(d)

    @classmethod
    def _from_dict(cls, d: dict):
        obj = cls._build(d)
        obj.fit_labels_flag = bool(d.get("fitLabels", False))
        return obj


@register_normalizer
class NormalizerStandardize(_BaseNormalizer):
    """Zero-mean unit-variance per feature (ref: NormalizerStandardize)."""

    def __init__(self):
        self.mean = self.std = None
        self.label_mean = self.label_std = None

    def _fit_arrays(self, x, y):
        self.mean = x.mean(axis=_feature_axes(x)).astype(np.float32)
        self.std = x.std(axis=_feature_axes(x)).astype(np.float32)
        self.std = np.where(self.std < 1e-8, 1.0, self.std)
        if self.fit_labels_flag and y is not None:
            self.label_mean = y.mean(axis=_feature_axes(y)).astype(np.float32)
            self.label_std = y.std(axis=_feature_axes(y)).astype(np.float32)
            self.label_std = np.where(self.label_std < 1e-8, 1.0,
                                      self.label_std)

    def _feature_stats(self):
        if self.mean is None:
            raise RuntimeError("normalizer not fitted")
        return self.mean, self.std

    def _label_stats(self):
        return self.label_mean, self.label_std

    @staticmethod
    def _tx(x, mean, std):
        return ((x - _bshape(x, mean)) / _bshape(x, std)).astype(np.float32)

    @staticmethod
    def _inv(x, mean, std):
        return (x * _bshape(x, std) + _bshape(x, mean)).astype(np.float32)

    def _stats_dict(self):
        d = {"mean": self.mean.tolist(), "std": self.std.tolist()}
        if self.label_mean is not None:
            d["labelMean"] = self.label_mean.tolist()
            d["labelStd"] = self.label_std.tolist()
        return d

    @classmethod
    def _build(cls, d):
        obj = cls()
        obj.mean = np.asarray(d["mean"], np.float32)
        obj.std = np.asarray(d["std"], np.float32)
        if "labelMean" in d:
            obj.label_mean = np.asarray(d["labelMean"], np.float32)
            obj.label_std = np.asarray(d["labelStd"], np.float32)
        return obj


@register_normalizer
class NormalizerMinMaxScaler(_BaseNormalizer):
    """Scale each feature into [lo, hi] (ref: NormalizerMinMaxScaler)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.fmin = self.fmax = None
        self.label_min = self.label_max = None

    def _fit_arrays(self, x, y):
        self.fmin = x.min(axis=_feature_axes(x)).astype(np.float32)
        self.fmax = x.max(axis=_feature_axes(x)).astype(np.float32)
        if self.fit_labels_flag and y is not None:
            self.label_min = y.min(axis=_feature_axes(y)).astype(np.float32)
            self.label_max = y.max(axis=_feature_axes(y)).astype(np.float32)

    def _feature_stats(self):
        if self.fmin is None:
            raise RuntimeError("normalizer not fitted")
        return self.fmin, self.fmax

    def _label_stats(self):
        return self.label_min, self.label_max

    def _tx(self, x, mn, mx):
        rng = np.where((mx - mn) < 1e-12, 1.0, mx - mn)
        unit = (x - _bshape(x, mn)) / _bshape(x, rng)
        return (unit * (self.hi - self.lo) + self.lo).astype(np.float32)

    def _inv(self, x, mn, mx):
        rng = np.where((mx - mn) < 1e-12, 1.0, mx - mn)
        unit = (x - self.lo) / (self.hi - self.lo or 1.0)
        return (unit * _bshape(x, rng) + _bshape(x, mn)).astype(np.float32)

    def _stats_dict(self):
        d = {"lo": self.lo, "hi": self.hi,
             "min": self.fmin.tolist(), "max": self.fmax.tolist()}
        if self.label_min is not None:
            d["labelMin"] = self.label_min.tolist()
            d["labelMax"] = self.label_max.tolist()
        return d

    @classmethod
    def _build(cls, d):
        obj = cls(d.get("lo", 0.0), d.get("hi", 1.0))
        obj.fmin = np.asarray(d["min"], np.float32)
        obj.fmax = np.asarray(d["max"], np.float32)
        if "labelMin" in d:
            obj.label_min = np.asarray(d["labelMin"], np.float32)
            obj.label_max = np.asarray(d["labelMax"], np.float32)
        return obj


@register_normalizer
class ImagePreProcessingScaler(_BaseNormalizer):
    """Pixel scaling u8 [0,255] -> [lo,hi], no fitting needed
    (ref: ImagePreProcessingScaler).

    Layout contract: 4-D image batches come OUT in NCHW (the framework's
    public layout). uint8 NHWC input (decode order) takes the fused
    u8->f32 pack (datasets/host_io.py); uint8/float NCHW input is
    value-scaled in place. revert_features inverts the VALUE scaling only
    and keeps NCHW."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0,
                 max_pixel: float = 255.0):
        self.lo = float(lo)
        self.hi = float(hi)
        self.max_pixel = float(max_pixel)

    def _fit_arrays(self, x, y):  # stateless — ref: fit is a no-op
        pass

    def transform(self, data):
        if isinstance(data, DataSet):
            data.features = self.transform(np.asarray(data.features))
            return data
        x = np.asarray(data)
        scale = (self.hi - self.lo) / self.max_pixel
        if _is_u8_nhwc(x):
            # unambiguous NHWC decode order -> fused pack to NCHW
            out = u8hwc_to_f32chw(x, scale=scale)
            return out + self.lo if self.lo else out
        # NCHW (or non-image ranks): value scaling only, layout unchanged
        return (x.astype(np.float32) * scale + self.lo).astype(np.float32)

    preprocess = transform

    def revert_features(self, x) -> np.ndarray:
        scale = (self.hi - self.lo) / self.max_pixel
        return ((np.asarray(x) - self.lo) / scale).astype(np.float32)

    def _stats_dict(self):
        return {"lo": self.lo, "hi": self.hi, "maxPixel": self.max_pixel}

    @classmethod
    def _build(cls, d):
        return cls(d.get("lo", 0.0), d.get("hi", 1.0),
                   d.get("maxPixel", 255.0))


@register_normalizer
class VGG16ImagePreProcessor(_BaseNormalizer):
    """Mean-subtraction preprocessing for the ImageNet VGG nets
    (ref: org.nd4j.linalg.dataset.api.preprocessor.VGG16ImagePreProcessor,
    used by the zoo VGG16/VGG19): subtract the ImageNet per-channel RGB
    means — no scaling to [0,1]. Stateless (fit is a no-op). Accepts
    3-channel images only: float NCHW [N,3,H,W], a single [3,H,W] image,
    or uint8 NHWC decode order [N,H,W,3] (packed + subtracted in one
    fused pass). Output is NCHW float32."""

    #: ImageNet training-set channel means, RGB order (the reference's
    #: VGG_MEAN_OFFSET values)
    RGB_MEANS = (123.68, 116.779, 103.939)

    def _fit_arrays(self, x, y):
        pass

    def fit_label(self, enabled: bool = True):
        if enabled:
            raise ValueError(
                "VGG16ImagePreProcessor transforms image FEATURES only "
                "(mean subtraction has no label analogue)")
        return self

    def _check_rgb(self, x: np.ndarray, axis: int) -> None:
        if x.shape[axis] != 3:
            raise ValueError(
                "VGG16ImagePreProcessor expects 3 RGB channels, got "
                f"shape {x.shape} (channel axis {axis})")

    def transform(self, data):
        if isinstance(data, DataSet):
            data.features = self.transform(np.asarray(data.features))
            return data
        x = np.asarray(data)
        means = np.asarray(self.RGB_MEANS, np.float32)
        if _is_u8_nhwc(x):
            self._check_rgb(x, 3)
            # one fused pass: u8 NHWC -> f32 NCHW with the mean folded in
            return u8hwc_to_f32chw(x, scale=1.0, mean=means)
        x = x.astype(np.float32)
        if x.ndim == 4:                        # NCHW batch
            self._check_rgb(x, 1)
            return x - means[None, :, None, None]
        if x.ndim == 3:                        # single CHW image
            self._check_rgb(x, 0)
            return x - means[:, None, None]
        raise ValueError(
            f"VGG16ImagePreProcessor expects image input, got rank "
            f"{x.ndim} shape {x.shape}")

    preprocess = transform

    def revert_features(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        means = np.asarray(self.RGB_MEANS, np.float32)
        if x.ndim == 4:
            self._check_rgb(x, 1)
            return x + means[None, :, None, None]
        if x.ndim == 3:
            self._check_rgb(x, 0)
            return x + means[:, None, None]
        raise ValueError(
            f"VGG16ImagePreProcessor expects image input, got rank "
            f"{x.ndim} shape {x.shape}")

    def _stats_dict(self):
        return {}

    @classmethod
    def _build(cls, d):
        return cls()
