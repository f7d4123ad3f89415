"""The ``legacy`` preset's pointwise photometric pass: CUDA kernel K5
(csrc/photometric.cu) and its plain PyTorch version.

Port of mmtrs_tpu/ops/pallas/photometric_kernel.py:photometrics_fused_pallas
(``_photometric_kernel``): per image, brightness/contrast → HSV shift →
Gaussian noise → one dropout hole, with a u8 store after every stage. The
params columns are the JAX package's (``P_*`` below).

Noise cannot follow the TPU's hardware PRNG. Both versions draw it from a
counter-based hash of the image's seed and the element index
e = (y·W + x)·3 + c within the image — ``fmix32(e·0x9E3779B1 + fmix32(seed))``
with murmur3's 32-bit finaliser — then the TPU kernel's Box–Muller on the
two 16-bit halves (``_normal_bits``). The plain version computes the bits
exactly with 32-bit products split into 16-bit halves, so int64 never
overflows.
"""

from __future__ import annotations

import functools
import math

import torch

from mmtrs_tpu_torch import _build
from mmtrs_tpu_torch.ops.clahe import quantize_u8
from mmtrs_tpu_torch.ops.color import hsv_shift, serial_cpu
from mmtrs_tpu_torch.ops.kernels import LAUNCHES, on_cuda, require, require_shape

P_BRIGHT, P_CONTRAST, P_DH, P_DS, P_DV, P_USE_HSV, P_SIGMA, P_DROP, P_Y0, P_X0 = range(10)
N_PARAMS = 10

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


def _mul32(h: torch.Tensor, k: int) -> torch.Tensor:
    """(h · k) mod 2³² for int64 h, k in [0, 2³²) without int64 overflow."""
    lo = (h & 0xFFFF) * k
    hi = ((h >> 16) * k) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def fmix32_ref(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finaliser on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_normals_ref(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """Standard normals [B, n] of the K5 noise for element indices 0..n−1."""
    key = fmix32_ref(seeds.long() & _M32)
    e = torch.arange(n, dtype=torch.int64, device=seeds.device)
    bits = fmix32_ref((_mul32(e, _GOLDEN)[None, :] + key[:, None]) & _M32)
    u1 = (bits & 0xFFFF).float() * (1.0 / 65536.0)
    u2 = ((bits >> 16) & 0xFFFF).float() * (1.0 / 65536.0)
    rad = torch.sqrt(-2.0 * serial_cpu(torch.log, 1.0 - u1))
    return rad * torch.cos((2.0 * math.pi) * u2)


def photometric_ref(
    imgs: torch.Tensor, params: torch.Tensor, seeds: torch.Tensor, hole: int
) -> torch.Tensor:
    """Plain version of :func:`photometric` (every stage on every image,
    selected per image; any device)."""
    B, H, W, _ = imgs.shape
    col = lambda i: params[:, i].view(B, 1, 1, 1)
    row = lambda m: m.view(B, 1, 1, 1)
    out = quantize_u8(imgs.float() * (1.0 + col(P_CONTRAST)) + col(P_BRIGHT) * 255.0)

    hsv = quantize_u8(hsv_shift(out.float(), params[:, P_DH], params[:, P_DS], params[:, P_DV]))
    out = torch.where(row(params[:, P_USE_HSV] > 0), hsv, out)

    sigma = col(P_SIGMA)
    noise = noise_normals_ref(seeds, H * W * 3).view(B, H, W, 3)
    out = torch.where(sigma > 0, quantize_u8(out.float() + noise * sigma), out)

    yy = torch.arange(H, dtype=torch.float32, device=imgs.device)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=imgs.device)[None, None, :]
    y0 = params[:, P_Y0, None, None]
    x0 = params[:, P_X0, None, None]
    in_hole = (
        (yy >= y0) & (yy < y0 + hole) & (xx >= x0) & (xx < x0 + hole)
        & (params[:, P_DROP] > 0)[:, None, None]
    )
    return torch.where(in_hole[..., None], torch.zeros_like(out), out)


def supports(H: int, W: int) -> bool:
    """Copy of mmtrs_tpu/ops/pallas/photometric_kernel.py:supports: the
    shapes on which the JAX package runs its fused photometric pass on a
    TPU, which also gates the ``legacy`` CLAHE member's fused LAB route
    (ops/augment.py). Held equal by tests/test_torch_hygiene.py."""
    return (W * 3) % 128 == 0 and H % 8 == 0


_THREADS = 256  # a K5 block's threads
_PX = 8  # pixels a K5 thread owns: 24 bytes, three 8-byte words
_MAX_GRID = 65535  # K5 puts the images on a grid dimension of this size


def launch_blocks(H: int, W: int) -> int:
    """K5's blocks per image: one job per 8-pixel chunk, and room for the
    job that takes the head and tail (:func:`image_split`) whenever they
    hold a pixel."""
    return -(-H * W // (_PX * _THREADS))


def image_split(out_addr: int, n: int) -> tuple[int, int, int]:
    """(head, chunks, tail) of an image of ``n`` pixels whose output starts
    at byte address ``out_addr``, as the kernel computes them: the ``head``
    pixels bring the output to its 8-byte grid (3·head = −out_addr mod 8),
    then ``chunks`` runs of 8 pixels go as whole 8-byte words, then the
    ``tail`` (< 8 pixels). Head and tail go byte by byte in one thread."""
    head = min(((8 - out_addr % 8) * 3) % 8, n)
    chunks = (n - head) // _PX
    return head, chunks, n - head - _PX * chunks


@functools.lru_cache(maxsize=64)
def _launch_args(B: int, H: int, W: int) -> tuple:
    """K5's (B, H, W, blocks per image); raises where the grid or an image's
    32-bit byte offsets do not reach."""
    if B > _MAX_GRID or 3 * H * W >= 2**31:
        raise ValueError(f"photometric: at most {_MAX_GRID} images of < 2^31 bytes, got {(B, H, W)}")
    return B, H, W, launch_blocks(H, W)


def _check(imgs: torch.Tensor, params: torch.Tensor, seeds: torch.Tensor, hole: int) -> bool:
    """Every check of :func:`photometric`, raising with its reason; True
    when the kernel must launch, False for the CPU plain version."""
    name = "photometric"
    require(name, imgs, torch.uint8, 4)
    require(name, params, torch.float32, 2)
    require(name, seeds, torch.int32, 1)
    B, H, W, C = imgs.shape
    if C != 3:
        raise ValueError(f"{name}: needs [B, H, W, 3] RGB, got {tuple(imgs.shape)}")
    require_shape(name, "params", params, (B, N_PARAMS))
    require_shape(name, "seeds", seeds, (B,))
    if int(hole) < 1:
        raise ValueError(f"{name}: hole must be >= 1, got {hole}")
    return on_cuda(name, imgs, params, seeds)


def photometric(
    imgs: torch.Tensor, params: torch.Tensor, seeds: torch.Tensor, hole: int
) -> torch.Tensor:
    """K5: u8 RGB [B, H, W, 3], params f32 [B, 10], seeds i32 [B], the
    dropout hole's side → u8 [B, H, W, 3]. The launch path is lean, as
    K7's: one expression accepts the arguments the kernel takes (every
    check of :func:`_check`); anything else goes through :func:`_check`,
    which raises or picks the plain version for CPU tensors."""
    B = imgs.shape[0] if imgs.dim() == 4 else -1
    fast = (  # get_device() is an int, where .device builds an object
        imgs.is_cuda and imgs.get_device() == params.get_device() == seeds.get_device()
        and imgs.dtype == torch.uint8 and imgs.dim() == 4 and imgs.shape[3] == 3
        and params.dtype == torch.float32 and params.shape == (B, N_PARAMS)
        and seeds.dtype == torch.int32 and seeds.shape == (B,) and hole >= 1
        and imgs.is_contiguous() and params.is_contiguous() and seeds.is_contiguous()
    )
    if not fast and not _check(imgs, params, seeds, hole):
        return photometric_ref(imgs, params, seeds, int(hole))
    out = torch.empty_like(imgs)
    _, H, W, _ = imgs.shape
    if B and H * W:
        code = _build.kernel("mmtrs_photometric")(
            imgs.data_ptr(), out.data_ptr(), params.data_ptr(), seeds.data_ptr(),
            *_launch_args(B, H, W), float(hole), _build.stream_handle(),
        )
        _build.check_launch("photometric", code)
        LAUNCHES["photometric"] += 1
    return out
