"""Match visualization (reference tools/utils.py:463-847 and
components/utils/evaluation_utils.py draw_match): side-by-side keypoint and
match rendering via OpenCV, host-side.

A copy of impx/tools/viz.py (numpy; cv2 and matplotlib imported inside the
functions). It keeps impx's behaviour where that differs from the reference:
`plot_matches_gt` ignores its `margin` argument, and reports n_gt_match = 1
when the ground truth has no match (ROADMAP C)."""
from __future__ import annotations

import numpy as np


def draw_points(img, points, color=(0, 255, 0), radius: int = 3):
    import cv2

    img = img.copy()
    for p in np.asarray(points):
        cv2.circle(img, (int(p[0]), int(p[1])), radius=radius, color=color)
    return img


def draw_matches(img0, img1, kpts0, kpts1, matches, inliers=None,
                 color_in=(0, 255, 0), color_out=(0, 0, 255)):
    """matches: [M,2] index pairs; inliers: optional [M] bool mask."""
    import cv2

    img0 = np.atleast_3d(img0)
    img1 = np.atleast_3d(img1)
    if img0.shape[2] == 1:
        img0 = np.repeat(img0, 3, axis=2)
    if img1.shape[2] == 1:
        img1 = np.repeat(img1, 3, axis=2)
    h = max(img0.shape[0], img1.shape[0])
    w = img0.shape[1] + img1.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: img0.shape[0], : img0.shape[1]] = img0
    canvas[: img1.shape[0], img0.shape[1]:] = img1
    off = img0.shape[1]
    matches = np.asarray(matches)
    if inliers is None:
        inliers = np.ones(len(matches), bool)
    for (i, j), ok in zip(matches, inliers):
        p0 = (int(kpts0[i][0]), int(kpts0[i][1]))
        p1 = (int(kpts1[j][0]) + off, int(kpts1[j][1]))
        cv2.line(canvas, p0, p1, color_in if ok else color_out, 1, cv2.LINE_AA)
    return canvas


def matches_from_indices0(indices0):
    """[N] matcher output (-1 unmatched) -> [M,2] index pairs."""
    indices0 = np.asarray(indices0)
    valid = indices0 > -1
    return np.stack([np.where(valid)[0], indices0[valid]], axis=1)


# --------------------------------------------------------------------------
# matplotlib figure suite (reference tools/utils.py:463-499, 737-847) —
# same API surface, reimplemented; matplotlib imported lazily so headless
# pipelines never pay for it.

def plot_image_pair(imgs, dpi=100, size=6, pad=0.5):
    """Two grayscale images side by side; returns (fig, axes)."""
    import matplotlib.pyplot as plt

    assert len(imgs) == 2, "number of images must be two"
    figsize = (size * 2, size * 3 / 4) if size is not None else None
    fig, ax = plt.subplots(1, 2, figsize=figsize, dpi=dpi)
    for a, im in zip(ax, imgs):
        a.imshow(im, cmap="gray", vmin=0, vmax=255)
        a.set_xticks([])
        a.set_yticks([])
        for spine in a.spines.values():
            spine.set_visible(False)
    fig.tight_layout(pad=pad)
    return fig, ax


def plot_keypoints(ax, kpts0, kpts1, color="w", ps=2):
    ax[0].scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
    ax[1].scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)


def plot_matches_fig(fig, ax, mkpts0, mkpts1, color, lw=1.5, ps=4):
    """Figure-space match lines between the two axes (per-match colors)."""
    import matplotlib.lines

    fig.canvas.draw()
    inv = fig.transFigure.inverted()
    f0 = inv.transform(ax[0].transData.transform(mkpts0))
    f1 = inv.transform(ax[1].transData.transform(mkpts1))
    fig.lines = [
        matplotlib.lines.Line2D((f0[i, 0], f1[i, 0]), (f0[i, 1], f1[i, 1]),
                                zorder=1, transform=fig.transFigure,
                                c=color[i], linewidth=lw)
        for i in range(len(mkpts0))
    ]
    ax[0].scatter(mkpts0[:, 0], mkpts0[:, 1], c=color, s=ps)
    ax[1].scatter(mkpts1[:, 0], mkpts1[:, 1], c=color, s=ps)


def error_colormap(x):
    """Red (x=0) -> yellow -> green (x=1) RGBA ramp; callers pass x = 1-error
    so correct matches render green (same convention as the reference's
    confidence coloring, tools/utils.py:850)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    # piecewise-linear through (1,0,0) -> (1,1,0) -> (0,1,0)
    red = np.minimum(1.0, 2.0 * (1.0 - x))
    green = np.minimum(1.0, 2.0 * x)
    return np.stack([red, green, np.zeros_like(x), np.ones_like(x)], -1)


def _pick_text_color(region, bright="k", dark="w"):
    """Black text on bright image regions, white on dark ones. Accepts uint8
    or float imagery; normalizes by the dtype's natural white point."""
    region = np.asarray(region, np.float64)
    white = 255.0 if region.max() > 1.5 else 1.0
    return bright if region.mean() / white > 0.72 else dark


def make_matching_plot(image0, image1, kpts0, kpts1, mkpts0, mkpts1, color,
                       text=(), path=None, show_keypoints=False,
                       fast_viz=False, small_text=()):
    """Annotated match figure (same API as reference tools/utils.py:737 so
    eval drivers are drop-in; rendering logic is impx's own). color: [M, 4]
    RGBA per match (e.g. error_colormap(1 - errors)). fast_viz routes to the
    cv2 canvas (returns the image array instead of saving a figure)."""
    if fast_viz:
        return make_matching_plot_fast(
            image0, image1, kpts0, kpts1, mkpts0, mkpts1, color, text=text,
            path=path, show_keypoints=show_keypoints, small_text=small_text)

    import matplotlib.pyplot as plt

    fig, ax = plot_image_pair([image0, image1])
    if show_keypoints:
        # single pass: small red dots with a thin white edge (readable on any
        # background without the double-scatter trick)
        for a, kp in zip(ax, (kpts0, kpts1)):
            a.scatter(kp[:, 0], kp[:, 1], s=12, c="r", edgecolors="w",
                      linewidths=0.4)
    plot_matches_fig(fig, ax, mkpts0, mkpts1, color)

    img0 = np.asarray(image0)
    h, w = img0.shape[:2]
    # sample the actual quadrants the two text blocks overlay
    fig.text(0.01, 0.99, "\n".join(text), transform=ax[0].transAxes,
             fontsize=15, va="top", ha="left",
             color=_pick_text_color(img0[: h // 3, : w // 3]))
    fig.text(0.01, 0.01, "\n".join(small_text), transform=ax[0].transAxes,
             fontsize=5, va="bottom", ha="left",
             color=_pick_text_color(img0[-(h // 3):, : w // 3]))
    if path is not None:
        fig.savefig(str(path), bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return fig


def _as_bgr(img):
    import cv2

    img = np.asarray(img)
    if img.dtype != np.uint8:
        white = 1.0 if img.max() <= 1.5 else 255.0
        img = np.clip(np.asarray(img, np.float64) / white * 255.0,
                      0, 255).astype(np.uint8)
    if img.ndim == 2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.shape[2] == 1:
        return cv2.cvtColor(img[..., 0], cv2.COLOR_GRAY2BGR)
    return img


def make_matching_plot_fast(image0, image1, kpts0, kpts1, mkpts0, mkpts1,
                            color, text=(), path=None, show_keypoints=False,
                            margin=10, opencv_display=False,
                            opencv_title="matches", small_text=()):
    """cv2-only annotated match canvas: side-by-side pair with `margin` px
    separation, per-match RGBA colors, optional keypoint rings, headline text
    top-left and small text bottom-left. Same call signature / canvas
    geometry as the reference's fast path (tools/utils.py:776) so demo/video
    drivers are drop-in; the rendering itself (color canvas assembly,
    vectorized color handling, ring keypoints, banner-backed text) is impx's
    own design. Returns the uint8 BGR canvas."""
    import cv2

    img0 = _as_bgr(image0)
    img1 = _as_bgr(image1)
    h0, w0 = img0.shape[:2]
    h1, w1 = img1.shape[:2]
    h, w = max(h0, h1), w0 + w1 + margin
    canvas = np.full((h, w, 3), 255, np.uint8)
    canvas[:h0, :w0] = img0
    canvas[:h1, w0 + margin:] = img1
    offset = np.array([w0 + margin, 0])

    if show_keypoints:
        # hollow rings (keeps the underlying pixel visible at the detection)
        for kp, off in ((kpts0, 0), (kpts1, offset[0])):
            for x, y in np.rint(np.asarray(kp)).astype(int):
                cv2.circle(canvas, (x + off, y), 3, (40, 40, 40), 1,
                           lineType=cv2.LINE_AA)

    mk0 = np.rint(np.asarray(mkpts0)).astype(int)
    mk1 = np.rint(np.asarray(mkpts1)).astype(int) + offset
    bgr = np.rint(np.asarray(color, np.float64)[:, 2::-1] * 255)
    bgr = np.clip(bgr, 0, 255).astype(int)
    for p0, p1, c in zip(mk0, mk1, bgr):
        c = tuple(int(v) for v in c)
        cv2.line(canvas, tuple(p0), tuple(p1), c, 1, lineType=cv2.LINE_AA)
        cv2.circle(canvas, tuple(p0), 3, c, -1, lineType=cv2.LINE_AA)
        cv2.circle(canvas, tuple(p1), 3, c, -1, lineType=cv2.LINE_AA)

    def banner_text(lines, anchor_top, scale):
        """White text over a darkened strip — readable on any imagery without
        per-glyph double-stroking."""
        if not lines:
            return
        font, thick = cv2.FONT_HERSHEY_SIMPLEX, 1
        sizes = [cv2.getTextSize(t, font, scale, thick)[0] for t in lines]
        line_h = max(s[1] for s in sizes) + int(10 * scale)
        pad = int(6 * scale)
        bw = max(s[0] for s in sizes) + 2 * pad
        bh = line_h * len(lines) + pad
        y0 = 0 if anchor_top else h - bh
        strip = canvas[y0:y0 + bh, :bw]
        strip[:] = (strip.astype(np.uint16) * 2 // 5).astype(np.uint8)
        for i, t in enumerate(lines):
            base = y0 + line_h * (i + 1) - int(4 * scale)
            cv2.putText(canvas, t, (pad, base), font, scale,
                        (255, 255, 255), thick, cv2.LINE_AA)

    scale = float(np.clip(h / 480.0, 0.6, 1.6))
    banner_text(list(text), anchor_top=True, scale=0.7 * scale)
    banner_text(list(small_text), anchor_top=False, scale=0.4 * scale)

    if path is not None:
        cv2.imwrite(str(path), canvas)
    if opencv_display:
        cv2.imshow(opencv_title, canvas)
        cv2.waitKey(1)
    return canvas


def eval_matches(pred_matches, gt_matches):
    """Inlier ratio of predicted matches + recall vs GT (reference
    tools/utils.py:855-878), vectorized: pred_matches [N,2] index pairs,
    gt_matches [K] with -1 = unmatched."""
    pred_matches = np.asarray(pred_matches).reshape(-1, 2)
    gt_matches = np.asarray(gt_matches)
    if len(pred_matches):
        correct = gt_matches[pred_matches[:, 0]] == pred_matches[:, 1]
        n_corr = int(np.sum(correct & (gt_matches[pred_matches[:, 0]] != -1)))
    else:
        n_corr = 0
    n_pred = len(pred_matches)
    n_gt = int(np.sum(gt_matches != -1))
    return {
        "inlier_ratio": n_corr / n_pred if n_pred > 0 else 0,
        "recall_ratio": n_corr / n_gt if n_gt > 0 else 0,
    }


def plot_matches_gt(image0, image1, kpts0, kpts1, pred_matches,
                    gt_matches=None, inliers=None, save_fn=None, margin=10,
                    show_keypoints=True):
    """GT-comparison match canvas (reference tools/utils.py:500-614
    `plot_matches_cv2` role): predicted matches drawn green when they agree
    with the GT assignment (or the pose-inlier mask when no GT is given) and
    red otherwise, with an optional GT-matches panel stacked below and a
    stats line `pred/correct/precision[/recall]`. Rendering reuses impx's own
    canvas assembly; correctness is computed vectorized. Returns a dict with
    the canvas and the same precision/recall statistics the reference
    returns.

    pred_matches: [N] indices into kpts1 (-1 = unmatched);
    gt_matches: optional [N] GT indices (-1 = unmatched);
    inliers: optional [N] bool (used for coloring when gt_matches is None).
    """
    import cv2

    pred_matches = np.asarray(pred_matches)
    pairs = matches_from_indices0(pred_matches)
    n_pred = len(pairs)
    if gt_matches is not None:
        gt_matches = np.asarray(gt_matches)
        good = gt_matches[pairs[:, 0]] == pairs[:, 1]
        n_corr = int(np.sum(good))
        n_gt = max(int(np.sum(gt_matches != -1)), 1)
    else:
        good = (np.asarray(inliers)[pairs[:, 0]].astype(bool)
                if inliers is not None else np.zeros(n_pred, bool))
        n_corr = int(np.sum(good))
        n_gt = 0

    canvas = draw_matches(_as_bgr(image0), _as_bgr(image1), kpts0, kpts1,
                          pairs, inliers=good)
    if show_keypoints:
        off = np.asarray(image0).shape[1]
        for kp, dx in ((kpts0, 0), (kpts1, off)):
            for x, y in np.rint(np.asarray(kp)).astype(int):
                cv2.circle(canvas, (x + dx, y), 3, (0, 0, 255), 1)

    denom = max(n_pred, 1)
    text = f"{n_pred}/{n_corr}/{n_corr / denom:.3f}"
    if gt_matches is not None:
        text += f"/{n_corr / n_gt:.3f}"
    cv2.putText(canvas, text, (20, 30), cv2.FONT_HERSHEY_SIMPLEX, 1,
                (0, 0, 255), 2)

    if gt_matches is not None:
        gt_pairs = matches_from_indices0(gt_matches)
        gt_canvas = draw_matches(_as_bgr(image0), _as_bgr(image1),
                                 kpts0, kpts1, gt_pairs)
        cv2.putText(gt_canvas, f"{len(gt_pairs)}/{len(gt_matches)}", (20, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 255), 2)
        canvas = np.vstack([canvas, gt_canvas])

    if save_fn is not None:
        cv2.imwrite(str(save_fn), canvas)
    return {
        "match_img": canvas,
        "inlier_ratio": n_corr / denom,
        "recall_ratio": n_corr / n_gt if n_gt else 0.0,
        "n_corr_match": n_corr,
        "n_gt_match": n_gt,
    }
