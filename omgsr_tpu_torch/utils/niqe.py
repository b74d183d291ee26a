"""NIQE — Natural Image Quality Evaluator (no-reference perceptual metric).

Mittal, Soundararajan, Bovik, "Making a 'Completely Blind' Image Quality
Analyzer", IEEE SPL 2013. Re-implemented from the paper: MSCN coefficients,
asymmetric-GGD moment matching over local 96x96 patches at two scales
(18 features/scale), and the Mahalanobis distance between the test image's
multivariate-Gaussian feature fit and a pristine-corpus MVG.

The reference repo evaluates on RealSR/DRealSR protocols whose papers
report NIQE alongside PSNR/SSIM but ships no metric code (README.md:45-90);
this module closes that gap for cli/eval_sr.py.

The canonical pristine MVG (the `niqe_image_params.mat` shipped with the
original MATLAB release) is not redistributable inside this repo, so the
pristine model is pluggable:

  - `fit_pristine(paths)` builds an MVG from any local folder of pristine
    images (with the paper's sharpness-based patch selection), saving an
    .npz of {mu, cov} — scores are then comparable *within* that model;
  - `load_pristine(path)` accepts such an .npz (or the official params
    converted to npz with keys mu/cov the day they are mountable).

Host-side numpy/scipy on purpose: an eval-time metric over variable-shape
images, not a training hot path. The same functions as the JAX package's
``utils/niqe.py`` (which imports no JAX), copied so the port depends on
nothing of that package.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate
from scipy.special import gamma as _gamma

# ---------------------------------------------------------------------------
# AGGD moment matching (paper eq. 3-5)
# ---------------------------------------------------------------------------

_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = _gamma(2.0 / _GAM) ** 2 / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def estimate_aggd(block: np.ndarray):
    """Estimate asymmetric generalized-Gaussian parameters (alpha, beta_l,
    beta_r) of a zero-mean sample by the moment-matching procedure of the
    NIQE/BRISQUE papers (r-hat inversion over a tabulated gamma-ratio)."""
    block = np.asarray(block, np.float64).ravel()
    neg = block[block < 0]
    pos = block[block > 0]
    left_std = np.sqrt(np.mean(neg**2)) if neg.size else 1e-6
    right_std = np.sqrt(np.mean(pos**2)) if pos.size else 1e-6
    gammahat = left_std / max(right_std, 1e-9)
    m1 = np.abs(block).mean()
    m2 = (block**2).mean()
    rhat = m1 * m1 / max(m2, 1e-12)
    rhatnorm = rhat * (gammahat**3 + 1) * (gammahat + 1) / (gammahat**2 + 1) ** 2
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    conv = np.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    return float(alpha), float(left_std * conv), float(right_std * conv)


# ---------------------------------------------------------------------------
# MSCN + per-patch features
# ---------------------------------------------------------------------------

def _gauss_kernel(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


_K7 = _gauss_kernel()


def mscn(img: np.ndarray):
    """Mean-subtracted contrast-normalized coefficients + the local-sigma
    field (used for sharpness-based patch selection when fitting)."""
    img = np.asarray(img, np.float64)
    mu = correlate(img, _K7, mode="nearest")
    sigma = np.sqrt(np.abs(correlate(img * img, _K7, mode="nearest") - mu * mu))
    return (img - mu) / (sigma + 1.0), sigma


_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))  # H, V, D1, D2 neighbor products


def patch_features(m: np.ndarray) -> np.ndarray:
    """18 NIQE features of one MSCN patch: (alpha, mean-of-betas) of the
    field itself + (alpha, eta, beta_l, beta_r) of 4 neighbor products."""
    alpha, bl, br = estimate_aggd(m)
    feats = [alpha, (bl + br) / 2.0]
    for dy, dx in _SHIFTS:
        pair = m * np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        a, l, r = estimate_aggd(pair)
        eta = (r - l) * (_gamma(2.0 / a) / _gamma(1.0 / a))
        feats.extend([a, eta, l, r])
    return np.asarray(feats, np.float64)


def _half_resize(img: np.ndarray) -> np.ndarray:
    """Antialiased 2x downscale (the paper's imresize(im, 0.5)): exact area
    resize = 2x2 mean pooling (dims are multiples of the 96 block, so even)."""
    h, w = img.shape
    return img[: h & ~1, : w & ~1].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def image_features(img_gray: np.ndarray, block: int = 96, min_blocks: int = 4):
    """Per-patch 36-d features (2 scales x 18) and scale-1 patch sharpness.

    img_gray: [0,255] float grayscale. Crops to a multiple of `block`.
    """
    img = np.asarray(img_gray, np.float64)
    h, w = img.shape
    nbh, nbw = h // block, w // block
    if nbh * nbw < min_blocks and min(h, w) >= 2 * block // 3:
        # small-image fallback: shrink the block so >=min_blocks patches fit
        block = max(min(h, w) // 2, 32)
        nbh, nbw = h // block, w // block
    if nbh == 0 or nbw == 0:
        raise ValueError(f"image {h}x{w} too small for NIQE (needs >= {block} px)")
    img = img[: nbh * block, : nbw * block]

    feats_scales = []
    sharp = None
    for scale in (1, 2):
        m, sigma = mscn(img)
        b = block // scale
        f = np.empty((nbh, nbw, 18))
        for by in range(nbh):
            for bx in range(nbw):
                f[by, bx] = patch_features(m[by * b : (by + 1) * b, bx * b : (bx + 1) * b])
        feats_scales.append(f.reshape(-1, 18))
        if scale == 1:
            sharp = np.asarray([
                sigma[by * b : (by + 1) * b, bx * b : (bx + 1) * b].mean()
                for by in range(nbh)
                for bx in range(nbw)
            ])
            img = _half_resize(img)
    return np.concatenate(feats_scales, axis=1), sharp


def to_gray255(rgb01: np.ndarray) -> np.ndarray:
    """BT.601 luma in [0,255] from RGB in [0,1] (the SR-eval convention,
    same matrix as cli.eval_sr's Y-channel mode)."""
    y = rgb01 @ np.asarray([65.481, 128.553, 24.966], np.float64) + 16.0
    return np.clip(y, 0, 255)


# ---------------------------------------------------------------------------
# pristine model fit / load / score
# ---------------------------------------------------------------------------

def fit_pristine(images: list[np.ndarray], sharpness_threshold: float = 0.75):
    """Fit the pristine MVG over patches selected by the paper's sharpness
    rule (patch mean-sigma > threshold * max over the image).

    images: list of RGB [0,1] float arrays. Returns {"mu", "cov"}.
    """
    rows = []
    for rgb in images:
        feats, sharp = image_features(to_gray255(rgb))
        keep = sharp > sharpness_threshold * sharp.max()
        if not keep.any():
            keep = np.ones_like(keep, bool)
        rows.append(feats[keep])
    allf = np.concatenate(rows, axis=0)
    allf = allf[np.isfinite(allf).all(axis=1)]
    return {"mu": allf.mean(axis=0), "cov": np.cov(allf, rowvar=False)}


def save_pristine(path: str, model: dict):
    np.savez(path, mu=model["mu"], cov=model["cov"])


def load_pristine(path: str) -> dict:
    d = np.load(path)
    return {"mu": np.asarray(d["mu"], np.float64), "cov": np.asarray(d["cov"], np.float64)}


def niqe(rgb01: np.ndarray, pristine: dict) -> float:
    """NIQE score of one RGB [0,1] image vs a pristine model (lower = more
    natural). Mahalanobis distance between MVG fits (paper eq. 10)."""
    feats, _ = image_features(to_gray255(rgb01))
    feats = feats[np.isfinite(feats).all(axis=1)]
    mu_t = feats.mean(axis=0)
    cov_t = np.cov(feats, rowvar=False) if feats.shape[0] > 1 else np.zeros((36, 36))
    d = pristine["mu"] - mu_t
    cov = (pristine["cov"] + cov_t) / 2.0
    return float(np.sqrt(max(d @ np.linalg.pinv(cov) @ d, 0.0)))


def main(argv=None):
    """python -m omgsr_tpu_torch.utils.niqe fit <pristine_dir> <out.npz> — build a
    pristine MVG from a folder of high-quality images for cli.eval_sr
    --niqe_params."""
    import argparse

    from PIL import Image

    from omgsr_tpu_torch.data.dataset import collect_paths

    p = argparse.ArgumentParser()
    p.add_argument("cmd", choices=["fit"])
    p.add_argument("pristine_dir", nargs="+")
    p.add_argument("out")
    args = p.parse_args(argv)
    imgs = [
        np.asarray(Image.open(q).convert("RGB"), np.float64) / 255.0
        for q in collect_paths(args.pristine_dir)
    ]
    if not imgs:
        raise SystemExit("no images found")
    save_pristine(args.out, fit_pristine(imgs))
    print(f"fitted pristine MVG over {len(imgs)} images -> {args.out}")


if __name__ == "__main__":
    main()
