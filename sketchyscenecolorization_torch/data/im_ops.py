"""Generic host image ops: the port's copy of
``sketchyscenecolorization_tpu/data/im_ops.py`` (reference
``Instance_Matching/data_processing/im_processing.py``).

The reference uses ``skimage.transform.resize`` (bilinear, float output);
this environment has no skimage, so resizing goes through PIL bilinear on
float32, which matches skimage's order-1 interpolation up to its optional
anti-aliasing prefilter (a <=2% effect on near-unity scales like the
768->mask-size eval resize at ``matching_main.py:325``)."""
from __future__ import annotations

import numpy as np
from PIL import Image


def _resize_float(im: np.ndarray, out_h: int, out_w: int,
                  method=Image.BILINEAR) -> np.ndarray:
    """Channelwise float resize via PIL (bilinear by default; BOX = AREA)."""
    im = np.asarray(im, dtype=np.float32)
    if im.ndim == 2:
        return np.array(Image.fromarray(im, mode="F").resize(
            (out_w, out_h), resample=method))
    chans = [np.array(Image.fromarray(im[..., c], mode="F").resize(
        (out_w, out_h), resample=method)) for c in range(im.shape[-1])]
    return np.stack(chans, axis=-1)


def resize_and_pad(im: np.ndarray, input_h: int, input_w: int) -> np.ndarray:
    """Aspect-preserving resize, zero-padded to (input_h, input_w)."""
    im_h, im_w = im.shape[:2]
    scale = min(input_h / im_h, input_w / im_w)
    resized_h = int(np.round(im_h * scale))
    resized_w = int(np.round(im_w * scale))
    pad_h = int(np.floor(input_h - resized_h) / 2)
    pad_w = int(np.floor(input_w - resized_w) / 2)
    resized = _resize_float(im, resized_h, resized_w)
    if im.ndim > 2:
        out = np.zeros((input_h, input_w, im.shape[2]), dtype=resized.dtype)
    else:
        out = np.zeros((input_h, input_w), dtype=resized.dtype)
    out[pad_h:pad_h + resized_h, pad_w:pad_w + resized_w, ...] = resized
    return out


def resize_and_crop(im: np.ndarray, input_h: int, input_w: int) -> np.ndarray:
    """Aspect-preserving resize, center-cropped to (input_h, input_w)."""
    im_h, im_w = im.shape[:2]
    scale = max(input_h / im_h, input_w / im_w)
    resized_h = int(np.round(im_h * scale))
    resized_w = int(np.round(im_w * scale))
    crop_h = int(np.floor(resized_h - input_h) / 2)
    crop_w = int(np.floor(resized_w - input_w) / 2)
    resized = _resize_float(im, resized_h, resized_w)
    return np.array(resized[crop_h:crop_h + input_h,
                            crop_w:crop_w + input_w, ...])


def bboxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """[n, H, W] (or [H, W]) masks -> [n, (xmin, ymin, xmax, ymax)]."""
    if masks.ndim == 2:
        masks = masks[np.newaxis, ...]
    bboxes = np.zeros((masks.shape[0], 4), dtype=np.int32)
    for n, m in enumerate(masks):
        idx = np.nonzero(m)
        bboxes[n] = [idx[1].min(), idx[0].min(), idx[1].max(), idx[0].max()]
    return bboxes


def crop_bboxes_subtract_mean(im: np.ndarray, bboxes, crop_size: int,
                              image_mean: np.ndarray) -> np.ndarray:
    """Crop each [xmin, ymin, xmax, ymax] box (inclusive), resize to
    crop_size^2, subtract the pixel mean (reference
    ``im_processing.crop_bboxes_subtract_mean``)."""
    bboxes = np.asarray(bboxes).reshape((-1, 4))
    out = np.zeros((bboxes.shape[0], crop_size, crop_size, 3), np.float32)
    for n, (xmin, ymin, xmax, ymax) in enumerate(bboxes):
        crop = im[ymin:ymax + 1, xmin:xmax + 1, :].astype(np.float32)
        out[n] = _resize_float(crop, crop_size, crop_size)
    return out - image_mean


def crop_masks_subtract_mean(im: np.ndarray, masks: np.ndarray,
                             crop_size: int, image_mean: np.ndarray
                             ) -> np.ndarray:
    """Mask out each instance (mean-filled background), crop its bbox,
    resize, subtract the mean (reference
    ``im_processing.crop_masks_subtract_mean``)."""
    if masks.ndim == 2:
        masks = masks[np.newaxis, ...]
    bboxes = bboxes_from_masks(masks)
    out = np.zeros((masks.shape[0], crop_size, crop_size, 3), np.float32)
    for n, mask in enumerate(masks):
        xmin, ymin, xmax, ymax = bboxes[n]
        masked = im.astype(np.float32) * mask[..., None] \
            + image_mean * (1 - mask[..., None])
        crop = masked[ymin:ymax + 1, xmin:xmax + 1, :]
        out[n] = _resize_float(crop, crop_size, crop_size)
    return out - image_mean
