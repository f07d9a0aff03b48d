"""Camera image crops for the image-branch tracker.

Port of point_cloud_reid_tpu/tracking/image_crops.py: project the 3D box
corners through lidar2camera and the intrinsics, clamp the 2D hull to the
image, keep the largest-area view when several cameras see a box, and
sample a fixed-size bilinear crop. Every box gets a crop slot (invisible
boxes get zeros), so all shapes are fixed.

Padded boxes sit at 1e6, where products overflow to inf or nan: anything
that depends on them is masked with torch.where, never by multiplying.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.boxes import box_corners_3d


def project_boxes(boxes: torch.Tensor, lidar2cam: torch.Tensor,
                  intrinsics: torch.Tensor,
                  image_size: Tuple[int, int] = (1600, 900)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project gravity-centred boxes into one camera, or into a stack of
    cameras at once.

    boxes (M, 7) [cx cy cz dx dy dz yaw]; lidar2cam (4, 4) or (ncam, 4, 4);
    intrinsics (3, 3) or (ncam, 3, 3); image_size (W, H). Returns
    corners_2d ([ncam,] M, 8, 2) in pixels and visible ([ncam,] M) bool: at
    least one corner in front of the camera and a clamped 2D box that keeps
    some area (BoxVisibility.ANY)."""
    b = boxes.clone()
    b[:, 2] -= boxes[:, 5] * 0.5                       # gravity -> bottom z
    corners = box_corners_3d(b)                          # (M, 8, 3) lidar
    M = corners.shape[0]
    hom = torch.cat([corners.reshape(-1, 3),
                     corners.new_ones((M * 8, 1))], dim=1)
    cam = (hom @ lidar2cam.transpose(-1, -2))[..., :3]
    cam = cam.reshape(lidar2cam.shape[:-2] + (M, 8, 3))  # camera frame
    z = cam[..., 2].clamp(min=1e-3)
    uvw = cam @ intrinsics.transpose(-1, -2)[..., None, :, :]
    uv = uvw[..., :2] / z[..., None]
    in_front = (cam[..., 2] > 0.1).any(dim=-1)
    b2 = boxes_2d(uv, image_size)
    visible = (in_front & (b2[..., 2] - b2[..., 0] > 1.0)
               & (b2[..., 3] - b2[..., 1] > 1.0))
    return uv, visible


def boxes_2d(corners_2d: torch.Tensor,
             image_size: Tuple[int, int] = (1600, 900)) -> torch.Tensor:
    """(..., 8, 2) corners -> (..., 4) [x0, y0, x1, y1] clamped to the
    image."""
    W, H = image_size
    x0 = corners_2d[..., 0].amin(dim=-1).clamp(0, W)
    x1 = corners_2d[..., 0].amax(dim=-1).clamp(0, W)
    y0 = corners_2d[..., 1].amin(dim=-1).clamp(0, H)
    y1 = corners_2d[..., 1].amax(dim=-1).clamp(0, H)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _sample_grid(box2d: torch.Tensor, H: int, W: int,
                 output_size: Tuple[int, int]):
    """Bilinear sample positions of (M, 4) pixel boxes: integer corners
    x0i, x1i (M, ow), y0i, y1i (M, oh) and the weights wx (M, ow), wy
    (M, oh) of the upper neighbour (grid_sample's pixel-centre convention)."""
    oh, ow = output_size
    b2 = box2d.float()
    x0, y0, x1, y1 = b2[:, 0], b2[:, 1], b2[:, 2], b2[:, 3]
    dev = b2.device
    xs = x0[:, None] + (x1 - x0)[:, None] * (
        torch.arange(ow, device=dev) + 0.5) / ow
    ys = y0[:, None] + (y1 - y0)[:, None] * (
        torch.arange(oh, device=dev) + 0.5) / oh
    xf = (xs - 0.5).clamp(0.0, W - 1.0)
    yf = (ys - 0.5).clamp(0.0, H - 1.0)
    x0i, y0i = xf.floor().long(), yf.floor().long()
    x1i, y1i = (x0i + 1).clamp(max=W - 1), (y0i + 1).clamp(max=H - 1)
    return x0i, x1i, y0i, y1i, xf - x0i, yf - y0i


def extract_crops(image: torch.Tensor, box2d: torch.Tensor,
                  output_size: Tuple[int, int] = (224, 224)) -> torch.Tensor:
    """Bilinear fixed-size crops of one image: image (3, H, W) float32,
    box2d (M, 4) [x0, y0, x1, y1] -> (M, 3, out_h, out_w)."""
    _, H, W = image.shape
    x0i, x1i, y0i, y1i, wx, wy = _sample_grid(box2d, H, W, output_size)
    wx, wy = wx[:, None, None, :], wy[:, None, :, None]

    def pick(yi, xi):                  # (M, 3, oh, ow)
        return image[:, yi[:, :, None], xi[:, None, :]].transpose(0, 1)

    top = pick(y0i, x0i) * (1 - wx) + pick(y0i, x1i) * wx
    bot = pick(y1i, x0i) * (1 - wx) + pick(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _crops_from_best(images: torch.Tensor, best_cam: torch.Tensor,
                     best_b2: torch.Tensor,
                     output_size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear crops straight from the (ncam, 3, H, W) stack of cameras.

    Gathers only the 2*oh sample rows each box needs, with the camera choice
    folded into the row gather's leading index, and blends columns on that
    band: the full best-camera image per box is never built. uint8 sources
    stay uint8 through both gathers, rows and columns, and become float32
    only on the (M, 2oh, 3, ow) column picks (uint8 values are exact in
    float32). Callers apply any value scale. The arithmetic is
    extract_crops's, operation for operation."""
    ncam, ch, H, W = images.shape
    oh, ow = output_size
    x0i, x1i, y0i, y1i, wx, wy = _sample_grid(best_b2, H, W, output_size)
    wx = wx[:, None, None, :]                            # (M, 1, 1, ow)
    yy = torch.cat([y0i, y1i], dim=1)                    # (M, 2*oh)
    # the broadcast index dimensions (M, 2oh) come first: (M, 2oh, ch, W)
    band = images[best_cam[:, None], :, yy, :]

    def cols(xi):
        idx = xi[:, None, None, :].expand(-1, 2 * oh, ch, -1)
        return torch.gather(band, 3, idx).float()

    horiz = cols(x0i) * (1.0 - wx) + cols(x1i) * wx      # (M, 2oh, ch, ow)
    top, bot = horiz[:, :oh], horiz[:, oh:]
    out = (top * (1.0 - wy)[:, :, None, None]
           + bot * wy[:, :, None, None])                 # (M, oh, ch, ow)
    return out.transpose(1, 2)                           # (M, ch, oh, ow)


def crops_per_frame(images: torch.Tensor, lidar2cams: torch.Tensor,
                    intrinsics: torch.Tensor, boxes: torch.Tensor,
                    image_size: Tuple[int, int] = (1600, 900),
                    output_size: Tuple[int, int] = (224, 224),
                    dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best camera's crop of every box of one frame.

    A box that several cameras see keeps its largest 2D view (the first of
    equal ones); a box no camera sees gets a zero crop and valid False.
    uint8 image stacks are gathered as uint8 and scaled by 1/255 on the
    crop.

    images (ncam, 3, H, W) float32 or uint8; lidar2cams (ncam, 4, 4);
    intrinsics (ncam, 3, 3); boxes (M, 7) gravity-centred. Returns crops
    (M, 3, out_h, out_w) and valid (M,) bool. The crops are computed in
    float32 and handed over in `dtype`, the ViT's compute dtype (its patch
    embedding would cast them to it: bf16 crops are the same numbers at
    half the bytes)."""
    uv, vis = project_boxes(boxes, lidar2cams, intrinsics, image_size)
    b2_all = boxes_2d(uv, image_size)                    # (ncam, M, 4)
    area = (b2_all[..., 2] - b2_all[..., 0]) * (b2_all[..., 3]
                                                - b2_all[..., 1])
    area_all = torch.where(vis, area, area.new_full((), -1.0))
    best_cam = area_all.argmax(dim=0)                    # first of equals
    valid = area_all.amax(dim=0) > 0
    M = boxes.shape[0]
    best_b2 = b2_all[best_cam, torch.arange(M, device=boxes.device)]
    crops = _crops_from_best(images, best_cam, best_b2, output_size)
    if images.dtype == torch.uint8:
        crops = crops * (1.0 / 255.0)
    crops = torch.where(valid[:, None, None, None], crops,
                        crops.new_zeros(()))
    return crops.to(dtype), valid
