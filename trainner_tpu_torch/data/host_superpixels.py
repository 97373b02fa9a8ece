"""The host's exact superpixel transform: the port's copy of
``trainner_tpu/data/host_superpixels.py`` (``superpixels``, ``label2rgb``
with avg / median / mix colouring, the numpy Felzenszwalb and grid-seeded
SLIC segmenters, and the ``selective``, ``cluster`` and ``rag``
reductions), on HWC float32 RGB images in [0, 1].

The segmenters, the colouring and the selective and rag reductions are
numpy and scipy. OpenCV serves the Lab / HSV conversion (``_cvt``), the
cluster reduction's k-means, the cv2-family pre-blur and the resizes to
and from ``max_size``; each is imported where it is used, and where OpenCV
is missing such a step raises ``host_degradations.HostOpUnavailable``
naming it (ROADMAP C 20). The device's superpixel op is
``ops/superpixel.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .host_degradations import cv2_for


# ---------------------------------------------------------------------------
# segmenters
# ---------------------------------------------------------------------------


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img
    from scipy.ndimage import gaussian_filter

    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = gaussian_filter(img[..., c], sigma, mode="nearest")
    return out


class _UnionFind:
    __slots__ = ("parent", "size", "thresh")

    def __init__(self, n: int, k: float):
        self.parent = np.arange(n)
        self.size = np.ones(n, np.int64)
        self.thresh = np.full(n, k, np.float64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> int:
        if self.size[a] < self.size[b]:
            a, b = b, a
        self.parent[b] = a
        self.size[a] += self.size[b]
        return a


def felzenszwalb(img: np.ndarray, scale: float = 10.0, sigma: float = 0.8,
                 min_size: int = 20) -> np.ndarray:
    """Felzenszwalb-Huttenlocher graph segmentation (the algorithm behind
    skimage.segmentation.felzenszwalb, which ref superpixels.py:241 uses
    with k=10, sigma=0.8, min_size=0.5*(h+w)/2.5).

    Segments by sorting 8-connected color-distance edges ascending and
    merging components whose internal variation + scale/|C| admits the
    edge; a final pass merges components below min_size. Returns an int
    label map (consecutive labels from 0)."""
    h, w = img.shape[:2]
    smooth = _gaussian_blur(img.astype(np.float64) * 255.0, sigma)
    flat = smooth.reshape(h * w, -1)
    idx = np.arange(h * w).reshape(h, w)

    pairs = []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        a = idx[max(0, -dy): h - max(0, dy),
                max(0, -dx): w - max(0, dx)].ravel()
        b = idx[max(0, dy): h + min(0, dy) or h,
                max(0, dx): w + min(0, dx) or w].ravel()
        pairs.append(np.stack([a, b], 1))
    edges = np.concatenate(pairs, 0)
    wts = np.sqrt(((flat[edges[:, 0]] - flat[edges[:, 1]]) ** 2).sum(1))
    order = np.argsort(wts, kind="stable")
    edges, wts = edges[order], wts[order]

    uf = _UnionFind(h * w, float(scale))
    thr = uf.thresh
    for (a, b), wt in zip(edges, wts):
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            continue
        if wt <= thr[ra] and wt <= thr[rb]:
            r = uf.union(ra, rb)
            thr[r] = wt + float(scale) / uf.size[r]
    # enforce min_size
    for (a, b) in edges:
        ra, rb = uf.find(a), uf.find(b)
        if ra != rb and (uf.size[ra] < min_size or uf.size[rb] < min_size):
            uf.union(ra, rb)

    roots = np.fromiter((uf.find(i) for i in range(h * w)), np.int64,
                        h * w)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.reshape(h, w).astype(np.int64)


def slic(img: np.ndarray, n_segments: int = 100, compactness: float = 10.0,
         n_iters: int = 10, sigma: float = 1.0) -> np.ndarray:
    """Grid-seeded SLIC (k-means in color+xy space; the numpy equivalent
    of the cv2.ximgproc / skimage.slic segmenters ref :216-240 selects).
    Expects the image already in the working color space; returns int
    labels."""
    h, w = img.shape[:2]
    x = _gaussian_blur(img.astype(np.float64) * 255.0, sigma)
    step = max(1, int(np.sqrt(h * w / max(1, n_segments))))
    cy = np.arange(step // 2, h, step)
    cx = np.arange(step // 2, w, step)
    gy, gx = np.meshgrid(cy, cx, indexing="ij")
    centers_yx = np.stack([gy.ravel(), gx.ravel()], 1).astype(np.float64)
    centers_c = x[gy.ravel(), gx.ravel()]

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float64)
    feats = x.reshape(h * w, -1)
    ratio = (compactness / step) ** 2

    labels = np.zeros(h * w, np.int64)
    for _ in range(max(1, n_iters)):
        # distance to every center, restricted implicitly by the spatial
        # term (full assignment is fine at host-exact sizes, max_size=128)
        dc = ((feats[:, None, :] - centers_c[None]) ** 2).sum(-1)
        ds = ((pos[:, None, :] - centers_yx[None]) ** 2).sum(-1)
        labels = np.argmin(dc + ratio * ds, axis=1)
        for k in range(len(centers_yx)):
            m = labels == k
            if m.any():
                centers_yx[k] = pos[m].mean(0)
                centers_c[k] = feats[m].mean(0)
    _, labels = np.unique(labels, return_inverse=True)
    return labels.reshape(h, w).astype(np.int64)


# ---------------------------------------------------------------------------
# label coloring (ref label2rgb:33)
# ---------------------------------------------------------------------------


def _segment_color(pixels: np.ndarray, kind: str) -> np.ndarray:
    if kind == "avg":
        return pixels.mean(0)
    if kind == "median":
        return np.median(pixels, 0)
    # 'mix' adaptive coloring (ref :104-119): std<20 -> mean,
    # 20..40 -> 0.5 mean + 0.5 median, >40 -> median (std in 0..255 units)
    std = np.std(pixels * 255.0)
    if std < 20:
        return pixels.mean(0)
    if std < 40:
        return 0.5 * pixels.mean(0) + 0.5 * np.median(pixels, 0)
    return np.median(pixels, 0)


def label2rgb(labels: np.ndarray, image: np.ndarray, kind: str = "mix",
              replace_samples: Sequence[bool] = (True,),
              reduced_colors: Optional[np.ndarray] = None,
              ret_rgb_labels: bool = False):
    """Paint each (replaced) segment with its aggregate color
    (ref label2rgb:33). With `reduced_colors`, paints the precomputed
    palette instead (the 'cluster' reduction path)."""
    replace_samples = list(replace_samples)
    out = (np.zeros_like(image) if (len(replace_samples) == 1 and
                                    replace_samples[0]) else image.copy())
    uniq = np.unique(labels)
    if reduced_colors is not None:
        for i, lab in enumerate(uniq):
            out[labels == lab] = reduced_colors[i]
        return out
    rgb_labels = []
    for i, lab in enumerate(uniq):
        if replace_samples[i % len(replace_samples)]:
            m = labels == lab
            color = _segment_color(image[m], kind)
            out[m] = color
            rgb_labels.append(color)
    if ret_rgb_labels:
        return out, rgb_labels
    return out


# ---------------------------------------------------------------------------
# selective-search reduction (ref :310-565)
# ---------------------------------------------------------------------------


def _lbp_channel(layer: np.ndarray) -> np.ndarray:
    """Classic 8-neighbor local binary pattern code (0..255), the
    'default' method of skimage local_binary_pattern(layer, 8, 1)
    (ref generate_lbp_image:518)."""
    p = np.pad(layer, 1, mode="edge")
    c = layer
    code = np.zeros(layer.shape, np.float64)
    offsets = ((0, 1), (-1, 1), (-1, 0), (-1, -1),
               (0, -1), (1, -1), (1, 0), (1, 1))
    for bit, (dy, dx) in enumerate(offsets):
        nb = p[1 + dy: 1 + dy + c.shape[0], 1 + dx: 1 + dx + c.shape[1]]
        code += (nb >= c) * (1 << bit)
    return code


def _region_hists(mask: np.ndarray, img: np.ndarray, lbp: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    color = np.concatenate([np.histogram(img[..., c][mask], 25)[0]
                            for c in range(img.shape[2])]).astype(float)
    tex = np.concatenate([np.histogram(lbp[..., c][mask], 10)[0]
                          for c in range(lbp.shape[2])]).astype(float)
    return color / color.sum(), tex / tex.sum()


def _region_neighbors(labels: np.ndarray, lab: int) -> List[int]:
    from scipy.ndimage import binary_dilation

    m = labels == lab
    ring = binary_dilation(m) & ~m
    return np.unique(labels[ring]).tolist()


def selective_search(img: np.ndarray, labels: np.ndarray,
                     seg_num: int = 200, sim_strategy: str = "CTSF",
                     ada_regions: bool = True) -> np.ndarray:
    """Hierarchical grouping with CTSF similarity (color/texture/size/
    fill histogram-intersection measures, ref selective_search:310 +
    HierarchicalGrouping:343). Merges the most-similar adjacent region
    pair until `seg_num` regions remain; returns the merged label map."""
    from scipy.ndimage import find_objects

    labels = labels.copy()
    h, w = labels.shape
    imsize = float(img.shape[0] * img.shape[1] * img.shape[2])
    lbp = np.stack([_lbp_channel(img[..., c].astype(np.float64))
                    for c in range(img.shape[2])], -1)

    regions: Dict[int, dict] = {}
    for lab in np.unique(labels):
        m = labels == lab
        sl = find_objects(m.astype(np.int32))[0]
        box = (sl[1].start, sl[0].start, sl[1].stop, sl[0].stop)
        ch, th = _region_hists(m, img, lbp)
        regions[lab] = {"size": int(m.sum()), "box": box,
                        "color_hist": ch, "texture_hist": th}

    if ada_regions and len(regions) > 2 * seg_num:
        seg_num = int(np.sqrt(h * w) * 0.8)

    def sim(ri, rj):
        s = 0.0
        if "C" in sim_strategy:
            s += np.minimum(ri["color_hist"], rj["color_hist"]).sum()
        if "T" in sim_strategy:
            s += np.minimum(ri["texture_hist"], rj["texture_hist"]).sum()
        if "S" in sim_strategy:
            s += 1.0 - (ri["size"] + rj["size"]) / imsize
        if "F" in sim_strategy:
            bb = ((max(ri["box"][2], rj["box"][2]) -
                   min(ri["box"][0], rj["box"][0])) *
                  (max(ri["box"][3], rj["box"][3]) -
                   min(ri["box"][1], rj["box"][1])))
            s += 1.0 - (bb - ri["size"] - rj["size"]) / imsize
        return s

    pairs: Dict[Tuple[int, int], float] = {}
    for i in regions:
        for j in _region_neighbors(labels, i):
            if i < j and j in regions:
                pairs[(i, j)] = sim(regions[i], regions[j])

    while len(pairs) > seg_num:
        i, j = max(pairs.items(), key=lambda kv: kv[1])[0]
        new = max(regions) + 1
        ri, rj = regions[i], regions[j]
        size = ri["size"] + rj["size"]
        regions[new] = {
            "size": size,
            "box": (min(ri["box"][0], rj["box"][0]),
                    min(ri["box"][1], rj["box"][1]),
                    max(ri["box"][2], rj["box"][2]),
                    max(ri["box"][3], rj["box"][3])),
            "color_hist": (ri["color_hist"] * ri["size"] +
                           rj["color_hist"] * rj["size"]) / size,
            "texture_hist": (ri["texture_hist"] * ri["size"] +
                             rj["texture_hist"] * rj["size"]) / size,
        }
        labels[labels == i] = new
        labels[labels == j] = new
        del regions[i], regions[j]
        pairs = {k: v for k, v in pairs.items()
                 if i not in k and j not in k}
        for n in _region_neighbors(labels, new):
            if n in regions:
                pairs[(n, new)] = sim(regions[new], regions[n])
    return labels


# ---------------------------------------------------------------------------
# RAG reduction (ref :570-596, skimage merge_hierarchical semantics)
# ---------------------------------------------------------------------------


def rag_merge(img: np.ndarray, labels: np.ndarray, thresh: float = 35.0
              ) -> np.ndarray:
    """Mean-color region-adjacency-graph hierarchical merge: repeatedly
    merge the lowest-weight adjacent pair while its mean-color L2
    distance < thresh (image in 0..255 units), recomputing weights from
    merged totals (ref merge_mean_color/_weight_mean_color)."""
    labels = labels.copy()
    x = img.astype(np.float64) * 255.0
    uniq = np.unique(labels)
    total = {int(l): x[labels == l].sum(0) for l in uniq}
    count = {int(l): int((labels == l).sum()) for l in uniq}
    mean = {l: total[l] / count[l] for l in total}

    adj: Dict[int, set] = {int(l): set() for l in uniq}
    for a, b in ((labels[:, :-1], labels[:, 1:]),
                 (labels[:-1, :], labels[1:, :])):
        diff = a != b
        for u, v in zip(a[diff].ravel(), b[diff].ravel()):
            adj[int(u)].add(int(v))
            adj[int(v)].add(int(u))

    import heapq

    heap = []
    for u in adj:
        for v in adj[u]:
            if u < v:
                heapq.heappush(
                    heap, (float(np.linalg.norm(mean[u] - mean[v])), u, v))
    alive = set(adj)
    while heap:
        wt, u, v = heapq.heappop(heap)
        if u not in alive or v not in alive or v not in adj[u]:
            continue
        if wt != float(np.linalg.norm(mean[u] - mean[v])):
            continue  # stale entry
        if wt >= thresh:
            break
        # merge v into u
        total[u] += total[v]
        count[u] += count[v]
        mean[u] = total[u] / count[u]
        labels[labels == v] = u
        adj[u] |= adj[v] - {u, v}
        for n in adj[v]:
            adj[n].discard(v)
            if n != u:
                adj[n].add(u)
        alive.discard(v)
        del total[v], count[v], mean[v], adj[v]
        for n in adj[u]:
            heapq.heappush(
                heap, (float(np.linalg.norm(mean[u] - mean[n])),
                       *sorted((u, n))))
    _, out = np.unique(labels, return_inverse=True)
    return out.reshape(labels.shape)


# ---------------------------------------------------------------------------
# orchestrator (ref superpixels:134 + segmentation_reduction:270)
# ---------------------------------------------------------------------------


def _cvt(img: np.ndarray, cs: Optional[str]) -> np.ndarray:
    if cs not in ("lab", "hsv"):
        return img
    cv2 = cv2_for(f"superpixels colour space {cs}")
    code = cv2.COLOR_RGB2LAB if cs == "lab" else cv2.COLOR_RGB2HSV
    u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return cv2.cvtColor(u8, code).astype(np.float32) / 255.0


def segmentation_reduction(img: np.ndarray, labels: np.ndarray,
                           n_segments: int, reduction: Optional[str],
                           kind: str = "mix", cs: Optional[str] = "lab"
                           ) -> np.ndarray:
    if reduction == "selective":
        base = label2rgb(labels, img, kind=kind)
        merged = selective_search(_cvt(base, cs), labels,
                                  seg_num=n_segments)
        return label2rgb(merged, img, kind=kind)
    if reduction == "cluster":
        cv2 = cv2_for("superpixels cluster reduction (k-means)")

        _, rgb_labels = label2rgb(labels, img, kind=kind,
                                  ret_rgb_labels=True)
        z = np.asarray(rgb_labels, np.float32)
        k = min(n_segments, len(z))
        criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER,
                    10, 1.0)
        _, klabels, centroids = cv2.kmeans(z, k, None, criteria, 10,
                                           cv2.KMEANS_RANDOM_CENTERS)
        return label2rgb(labels, img,
                         reduced_colors=centroids[klabels.ravel()])
    if reduction == "rag":
        merged = rag_merge(img, labels, thresh=35.0)
        return label2rgb(merged, img, kind=kind)
    return img


def superpixels(img: np.ndarray, n_segments: int = 200,
                cs: Optional[str] = None, n_iters: int = 10,
                algo: str = "slic", kind: str = "mix",
                reduction: Optional[str] = None,
                replace_samples: Sequence[bool] = (True,),
                max_size: Optional[int] = 128) -> np.ndarray:
    """Full superpixel transform (ref superpixels:134): optional
    downscale to max_size, color-space conversion, segmentation, color
    aggregation (with per-segment replace sampling) or reduction, and
    upscale back. Input/output HWC float32 RGB [0, 1]."""
    if not np.any(replace_samples):
        return img
    orig_shape = img.shape
    work = img
    size = max(img.shape[:2])
    if max_size is not None and size > max_size:
        s = max_size / size
        cv2 = cv2_for("superpixels resize to max_size")
        work = cv2.resize(img, (int(img.shape[1] * s),
                                int(img.shape[0] * s)),
                          interpolation=cv2.INTER_LINEAR)

    sk = algo.startswith("sk_")
    if not cs:
        cs = "lab" if sk else "hsv"  # ref :186-197 defaults
    img_sp = work
    if not sk:  # cv2-family algos pre-blur (ref :181-183)
        img_sp = cv2_for(f"superpixels pre-blur of {algo}").GaussianBlur(
            img_sp, (0, 0), 3)
    img_sp = _cvt(img_sp, cs)

    h, w = img_sp.shape[:2]
    if algo == "sk_felzenszwalb":
        min_size = int(0.5 * (h + w) / 2.5)
        labels = felzenszwalb(img_sp, scale=10.0, sigma=0.8,
                              min_size=min_size)
    else:  # seeds/slic/slico/mslic/sk_slic -> SLIC family
        labels = slic(img_sp, n_segments=n_segments, compactness=10.0,
                      n_iters=n_iters, sigma=1.0 if sk else 0.0)

    if len(np.unique(labels)) > n_segments and reduction:
        rgbmap = segmentation_reduction(work, labels, n_segments,
                                        reduction, kind, cs="lab")
    else:
        rgbmap = label2rgb(labels, work, kind=kind,
                           replace_samples=replace_samples)

    if rgbmap.shape != orig_shape:
        cv2 = cv2_for("superpixels resize back")
        rgbmap = cv2.resize(rgbmap, (orig_shape[1], orig_shape[0]),
                            interpolation=cv2.INTER_LINEAR)
    return np.clip(rgbmap.astype(np.float32), 0.0, 1.0)
