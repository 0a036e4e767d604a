"""Image ops (counterpart of ``keystone_tpu/ops/images.py`` § Convolver,
Pooler, SymmetricRectifier, PixelScaler, GrayScaler, ImageVectorizer,
Windower, RandomPatcher, CenterCornerPatcher).  Images are NHWC, as in
the reference; the convolutions and pools run NCHW, as cuDNN takes
them, and hand NHWC back.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from keystone_tpu_torch.utils import precision
from keystone_tpu_torch.workflow.dataset import Dataset
from keystone_tpu_torch.workflow.transformer import Transformer, tensor_identity


def _nchw(xs: torch.Tensor) -> torch.Tensor:
    """NHWC (or NHW, one channel) as f32 NCHW."""
    if xs.ndim == 3:
        xs = xs[..., None]
    return xs.to(torch.float32).permute(0, 3, 1, 2)


def _valid_extent(size: int, window: int, stride: int) -> int:
    """Windows of a VALID sweep along one axis: none where the window does
    not fit, as in the reference, where the torch ops raise."""
    return (size - window) // stride + 1 if size >= window else 0


class Convolver(Transformer):
    """K filters convolved over images, VALID (Convolver.scala, the CIFAR
    feature extractor).  ``filters``: (K, fh, fw, c); ``offset``: (K,) or
    None, added to every output.  :meth:`from_whitened_patches` folds a
    ZCA whitening of the patches into the filters and the offset.

    Two physical forms of the same product:

    - ``"direct"``: ``F.conv2d`` (cuDNN, in true f32);
    - ``"im2col"``: the patches unfolded in (c, fh, fw) order and one
      (n·oh·ow, c·fh·fw) × (c·fh·fw, K) product, the reference's own
      execution plan;
    - ``"auto"``: resolved per batch, from the images' shape, by
      ``_pick_conv_strategy``."""

    def __init__(self, filters: torch.Tensor, stride: int = 1, offset: Optional[torch.Tensor] = None,
                 strategy: str = "auto"):
        super().__init__()
        if strategy not in ("auto", "direct", "im2col"):
            raise ValueError(f"unknown Convolver strategy {strategy!r}")
        self.register_buffer("filters", filters.to(torch.float32))
        self.register_buffer("offset", offset)
        self.stride = int(stride)
        self.strategy = strategy

    @classmethod
    def from_whitened_patches(cls, patches: torch.Tensor, whitener, patch_shape, stride: int = 1) -> "Convolver":
        """Filters from K whitened flat patches (K, fh·fw·c), in RandomPatcher's
        (fh, fw, c) order, and the fitted ZCAWhitener: convolving whitened
        patches with them equals convolving raw patches with W·Pᵀ plus the
        offset −mean·W·Pᵀ, one product in place of two."""
        fh, fw, c = patch_shape
        w_eff = whitener.whitener @ patches.to(torch.float32).T  # (d, K)
        offset = -(whitener.mean @ w_eff)
        return cls(w_eff.T.reshape(-1, fh, fw, c), stride=stride, offset=offset)

    def params(self):
        return (tuple(self.filters.shape), tensor_identity(self.filters, self.offset), self.stride,
                self.offset is None, self.strategy)

    def apply_batch(self, xs, mask=None):
        x = _nchw(xs)
        k, fh, fw, _ = self.filters.shape
        oh, ow = _valid_extent(x.shape[2], fh, self.stride), _valid_extent(x.shape[3], fw, self.stride)
        if oh == 0 or ow == 0:  # an image smaller than the filters
            return torch.zeros((x.shape[0], oh, ow, k), device=x.device)
        strategy = self.strategy
        if strategy == "auto":
            strategy = _pick_conv_strategy(x.shape[2], x.shape[3], tuple(self.filters.shape), self.stride)
        out = self._im2col(x) if strategy == "im2col" else self._direct(x)
        return out if self.offset is None else out + self.offset

    def _direct(self, x):
        with precision.f32_convolutions():  # cuDNN's default TF32 keeps ~3 digits
            out = F.conv2d(x, self.filters.permute(0, 3, 1, 2), stride=self.stride)
        return out.permute(0, 2, 3, 1)

    def _im2col(self, x):
        k, fh, fw, c = self.filters.shape
        n, _, h, w = x.shape
        oh, ow = (h - fh) // self.stride + 1, (w - fw) // self.stride + 1
        patches = F.unfold(x, (fh, fw), stride=self.stride)  # (n, c·fh·fw, oh·ow), (c, fh, fw) order
        rhs = self.filters.permute(3, 1, 2, 0).reshape(c * fh * fw, k)
        return torch.matmul(patches.transpose(1, 2), rhs).reshape(n, oh, ow, k)


#: The Convolver's ``auto`` rule: im2col from this many patch elements an
#: image (oh·ow·fh·fw·c) up, the direct form below.  The reference's rule
#: (im2col below 58 000, its own devices' crossover) does not carry over.
#: On an NVIDIA H100 80GB HBM3 at 700 W, 256 filters of 6×6×3 over a
#: chunk of 128 images (``chip_smoke.py``, PERF.md): direct 0.37 / 1.65 /
#: 3.89 / 7.06 / 11.21 ms and im2col 1.56 / 2.50 / 4.03 / 6.10 / 8.18 ms
#: at 32 / 64 / 96 / 128 / 160 px (894 348 and 1 633 932 patch elements
#: an image at 96 and 128 px); RandomPatchCifar's 32 px takes direct.
_IM2COL_MIN_PATCH_ELEMENTS = 1_200_000


def _pick_conv_strategy(h: int, w: int, filter_shape, stride: int) -> str:
    _, fh, fw, c = filter_shape
    oh = max(0, (h - fh) // stride + 1)
    ow = max(0, (w - fw) // stride + 1)
    return "im2col" if oh * ow * fh * fw * c >= _IM2COL_MIN_PATCH_ELEMENTS else "direct"


class Pooler(Transformer):
    """Pooling over a grid of windows, VALID (Pooler.scala): out[g] is the
    sum (``pool_mode="sum"``) or the max of ``pixel_fn(x)`` over window g;
    a last partial window is dropped."""

    def __init__(self, stride: int, pool_size: int, pixel_fn: Optional[Callable] = None, pool_mode: str = "sum"):
        super().__init__()
        if pool_mode not in ("sum", "max"):
            raise ValueError(f"unknown pool mode {pool_mode}")
        self.stride = int(stride)
        self.pool_size = int(pool_size)
        self.pixel_fn = pixel_fn
        self.pool_mode = pool_mode

    def params(self):
        return (self.stride, self.pool_size, self.pool_mode, self.pixel_fn is None)

    def apply_batch(self, xs, mask=None):
        x = xs.to(torch.float32)
        if self.pixel_fn is not None:
            x = self.pixel_fn(x)
        x = x.permute(0, 3, 1, 2)
        oh = _valid_extent(x.shape[2], self.pool_size, self.stride)
        ow = _valid_extent(x.shape[3], self.pool_size, self.stride)
        if oh == 0 or ow == 0:  # an image smaller than the window
            return torch.zeros((x.shape[0], oh, ow, x.shape[1]), device=x.device)
        if self.pool_mode == "sum":
            out = F.avg_pool2d(x, self.pool_size, self.stride, divisor_override=1)
        else:
            out = F.max_pool2d(x, self.pool_size, self.stride)
        return out.permute(0, 2, 3, 1)


class SymmetricRectifier(Transformer):
    """[max(x − α, maxVal), max(−x − α, maxVal)] on the channel axis
    (SymmetricRectifier.scala): twice the channels."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        super().__init__()
        self.max_val = float(max_val)
        self.alpha = float(alpha)

    def params(self):
        return (self.max_val, self.alpha)

    def apply_batch(self, xs, mask=None):
        return torch.cat([torch.clamp(xs - self.alpha, min=self.max_val),
                          torch.clamp(-xs - self.alpha, min=self.max_val)], dim=-1)


class PixelScaler(Transformer):
    """uint8 pixels → [0,1] floats (nodes/images/PixelScaler.scala).

    ``only_if_integer=True`` divides only integer inputs and passes
    floating inputs through as f32, so a pipeline that is fed uint8 also
    accepts images already in [0, 1]."""

    def __init__(self, scale: float = 255.0, only_if_integer: bool = False):
        super().__init__()
        self.scale = float(scale)
        self.only_if_integer = bool(only_if_integer)

    def params(self):
        return (self.scale, self.only_if_integer)

    def apply_batch(self, xs, mask=None):
        if self.only_if_integer and xs.is_floating_point():
            return xs.to(torch.float32)
        return xs.to(torch.float32) / self.scale


class GrayScaler(Transformer):
    """NHWC → NHW luminance via the channel mean (nodes/images/GrayScaler.scala)."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        if xs.ndim == 3 or xs.shape[-1] == 1:
            return xs.reshape(xs.shape[:3])
        # integer pixels average in f32, as jnp.mean does
        return xs.mean(dim=-1, dtype=None if xs.is_floating_point() else torch.float32)


class ImageVectorizer(Transformer):
    """Image → flat vector (nodes/images/ImageVectorizer.scala)."""

    def params(self):
        return ()

    def apply_batch(self, xs, mask=None):
        return xs.reshape(xs.shape[0], -1)


class CenterCornerPatcher(Transformer):
    """Center + 4 corner crops, optionally horizontally flipped
    (nodes/images/CenterCornerPatcher.scala) — the 10-view test-time
    augmentation for ImageNet.  Output: (n, num_views, ph, pw, C)."""

    def __init__(self, patch_h: int, patch_w: int, horizontal_flips: bool = False):
        super().__init__()
        self.patch_h = int(patch_h)
        self.patch_w = int(patch_w)
        self.horizontal_flips = bool(horizontal_flips)

    def params(self):
        return (self.patch_h, self.patch_w, self.horizontal_flips)

    def apply_batch(self, xs, mask=None):
        if xs.ndim == 3:
            xs = xs[..., None]
        _, h, w, _ = xs.shape
        ph, pw = self.patch_h, self.patch_w
        starts = [(0, 0), (0, w - pw), (h - ph, 0), (h - ph, w - pw), ((h - ph) // 2, (w - pw) // 2)]
        views = [xs[:, y:y + ph, x:x + pw, :] for (y, x) in starts]
        if self.horizontal_flips:
            views += [torch.flip(v, dims=(2,)) for v in views]
        return torch.stack(views, dim=1)


class Windower(Transformer):
    """Sliding-window patches (Windower.scala): (n, H, W, C) → (n,
    windows, ws·ws·C), windows in row-major order and each patch in
    (dy, dx, c) order."""

    def __init__(self, step: int, window_size: int):
        super().__init__()
        self.step = int(step)
        self.window_size = int(window_size)

    def params(self):
        return (self.step, self.window_size)

    def apply_batch(self, xs, mask=None):
        x = _nchw(xs)
        n, c = x.shape[:2]
        ws = self.window_size
        if _valid_extent(x.shape[2], ws, self.step) == 0 or _valid_extent(x.shape[3], ws, self.step) == 0:
            return torch.zeros((n, 0, ws * ws * c), device=x.device)
        patches = F.unfold(x, ws, stride=self.step)  # (n, c·ws·ws, L), (c, dy, dx) order
        return patches.reshape(n, c, ws, ws, -1).permute(0, 4, 2, 3, 1).reshape(n, -1, ws * ws * c)


class RandomPatcher(Transformer):
    """Random patches of the training images (RandomPatcher.scala):
    (n, H, W, C) → (n·num_patches, ph·pw·C), each patch in (dy, dx, c)
    order.  The offsets are drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (``offsets``), so every device takes the same patches;
    ``extract`` takes given offsets (the reference's, in parity tests)."""

    fusable = False

    def __init__(self, num_patches: int, patch_h: int, patch_w: int, seed: int = 0):
        super().__init__()
        self.num_patches = int(num_patches)
        self.patch_h = int(patch_h)
        self.patch_w = int(patch_w)
        self.seed = int(seed)

    def params(self):
        return (self.num_patches, self.patch_h, self.patch_w, self.seed)

    def offsets(self, n: int, h: int, w: int):
        """(ys, xs): (n, num_patches) int64 top-left corners."""
        g = torch.Generator().manual_seed(self.seed)
        ys = torch.randint(0, h - self.patch_h + 1, (n, self.num_patches), generator=g)
        xs = torch.randint(0, w - self.patch_w + 1, (n, self.num_patches), generator=g)
        return ys, xs

    def extract(self, images, ys, xs) -> torch.Tensor:
        """The patches of images (n, H, W, C) at corners ys, xs (n, k)."""
        if images.ndim == 3:
            images = images[..., None]
        n, _, _, c = images.shape
        dev = images.device
        rows = torch.as_tensor(ys, device=dev)[..., None] + torch.arange(self.patch_h, device=dev)
        cols = torch.as_tensor(xs, device=dev)[..., None] + torch.arange(self.patch_w, device=dev)
        item = torch.arange(n, device=dev)[:, None, None, None]
        patches = images[item, rows[..., :, None], cols[..., None, :]]  # (n, k, ph, pw, C)
        return patches.to(torch.float32).reshape(-1, self.patch_h * self.patch_w * c)

    def apply_batch(self, xs, mask=None):
        return self.extract(xs, *self.offsets(xs.shape[0], xs.shape[1], xs.shape[2]))

    def apply_dataset(self, ds: Dataset) -> Dataset:
        """Every image's patches, drawn over the whole set at once."""
        return Dataset(self.apply_batch(ds.array[:ds.n]))
