"""A small raster for the port's figures, on numpy and the standard
library alone: an RGB canvas of floats in [0, 1], anti-aliased line
segments and filled discs, a bitmap font, the viridis colormap with
matplotlib's normalization, and a PNG writer on ``zlib``.

The figures (``visualize.py``) describe what they draw as data (segments,
points and their colours) and draw it here; nothing is measured in
pixels but the figure's size, which follows matplotlib's
``savefig(dpi=150)``: ``int(inches · dpi)`` each side.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

# The 95 printable ASCII glyphs, 32 to 126, separated by "|": each is
# "advance top width rows" (pixels; top = rows above the baseline of the
# first row; each row a hex number of ``width`` bits, the leftmost pixel
# the highest bit), or the advance alone for a blank glyph.  Rasterized
# once from DejaVu Sans at 12 px without anti-aliasing (Bitstream Vera
# license).
_FONT = (
    "4|5 9 1 111111011|5 9 3 555|10 8 8 12147f2424fe2848|8 9 5 040e15141c0705"
    "150e0404|11 9 10 1842482482501b6029049049086|10 9 8 30484060518986c47b|3"
    " 9 1 111|5 10 3 32244444223|5 10 3 62211111226|6 9 5 04150e0e1504|10 7 7"
    " 0808087f080808|4 2 1 111|4 4 3 7|4 2 1 11|4 9 4 1122244488|8 9 6 1e1221"
    "21212121121e|8 9 5 1c040404040404041f|8 9 6 1e230101020408103f|8 9 6 1e2"
    "101010e0101211e|8 9 6 06060a1212223f0202|8 9 6 3e20203e030101231e|8 9 6 "
    "0e11202e332121131e|8 9 6 3f0102020404080810|8 9 6 1e2121211e2121211e|8 9"
    " 6 1e322121331d01221c|4 6 1 110011|4 6 1 1100111|10 7 8 031ee0e01e03|10 "
    "5 8 ff00ff|10 7 8 c078070778c0|6 9 5 0e1101020404000404|13 9 11 0f810620"
    "247948948948a47c2001040f8|8 9 8 1818242424427e4281|8 9 6 3e2121213e21212"
    "13e|8 9 6 0e112020202020110e|9 9 7 7c424141414141427c|8 9 6 3f2020203f20"
    "20203f|7 9 5 1f1010101f10101010|9 9 7 1e214040474141211e|9 9 7 414141417"
    "f41414141|3 9 1 111111111|3 9 3 11111111116|7 9 6 212224283028242221|6 9"
    " 5 10101010101010101f|10 9 8 81c3c3a5a599998181|9 9 7 616151514945454343"
    "|9 9 7 1c224141414141221c|8 9 6 3e2121213e20202020|9 9 7 1c2241414141412"
    "21c0402|8 9 7 7c4242427c44424241|8 9 6 1e2120201e0101211e|7 9 7 7f080808"
    "0808080808|9 9 7 41414141414141633e|8 9 9 081081042042042024024018018|11"
    " 9 11 421222222252154154154088088|7 9 7 632214140814142241|7 9 7 4122221"
    "41408080808|9 9 7 7f010204081020407f|5 9 2 32222222223|4 9 4 8844422211|"
    "5 9 2 31111111113|10 9 7 0c1221|6 -2 6 3f|6 10 3 21|8 7 6 1e21011f21231d"
    "|8 10 6 2020203e33212121333e|7 7 5 0e19101010190e|8 10 6 0101011f3321212"
    "1331f|8 7 6 1e33213f20311e|4 10 4 344f444444|8 7 6 1f33212121331f01130e|"
    "8 10 6 2020202e312121212121|3 9 1 101111111|3 9 2 101111111113|7 10 5 10"
    "101011121418141211|3 10 1 1111111111|11 7 9 1ee111111111111111111|8 7 6 "
    "2e312121212121|8 7 6 1e33212121331e|8 7 6 3e33212121333e202020|8 7 6 1f3"
    "3212121331f010101|5 7 4 bc88888|7 7 5 0e11100e01110e|5 9 4 44f444447|8 7"
    " 6 2121212121231d|6 7 6 21211212120c0c|9 7 9 1111110aa0aa0aa044044|6 7 6"
    " 2112120c121221|6 7 6 212112120a0c04040830|5 7 5 1f01020408101f|8 9 5 07"
    "04040404180404040407|4 9 1 111111111111|8 9 5 1c0404040403040404041c|10 "
    "5 8 718e"
)

# matplotlib's viridis: 256 RGB entries, each channel in millionths, four
# base-36 digits each
_VIRIDIS = (
    "5q0s03re726f5r6m07et76tf5sag0ba97ber5tc90fdy7fyd5uc20jq37kg55v9t0oax7ow5"
    "5w5k0t4o7ta75wza0y2v7xmc5xqy12ug81wj5ygl17gk864n5z471by98aao5zpq1gcc8eel"
    "60971knd8igb60qm1ovv8mft615y1t288qd261j81x6q8u7z61uf219n8y0j623k25b891qo"
    "62am29bl95ee62fn2dax98zm62il2h9c9cib62jh2l6x9fyg62ib2p3s9jc062f42szz9mmx"
    "629w2wvk9pv7622n30qm9t0t61te34l49w3q61i738f59z3x61503c8qa21d60pw3g1va4w3"
    "608v3jula7o25zpy3nmvaad95z563reqaczp5yik3v67afjd5xu63yx8ai0a5x4242nuakeh"
    "5wc746e1ampx5vio4a3taoyn5uni4dt4ar4p5tqs4hhzat825ssj4l6dav8s5rss4ouaax6x"
    "5qrk4shpaz2g5pp04w4mb0vh5ol54zr0b2lz5nfz53cvb4a25m9m56y6b5vp5l235aiyb7f0"
    "5jth5e35b8w05iju5hmqbaar5h995l5rbbnc5fxr5oo6bcxr5ele5s5zbe635d895vn6bfcf"
    "5bud5z3rbggs5afv62jpbhj9590s65yzbijw57l569dobjis56516crpbkfx54oi6g53blbg"
    "537l6jhubm5d51qe6mtzbmxs508z6q5gbnoq4yre6tgaboea4x9n6wqhbp2i4vru7002bppg"
    "4u9z7391bqb64ss576hebqvp4rad79p5brf44psp7cwbbrxh4ob67g2wbseu4mtu7j8vbsv7"
    "4lcq7mebbtao4jvv7pj7btpa4ifb7snjbu324gz37vrcbug34fj87yumbusd4e3r81xebv3x"
    "4con84zobvet4b9z881ibvp249vq8b2vbvyq48hw8e3sbw7t474k8h49bwgc45ro8k4bbwod"
    "44f98n3zbwvw433b8q39bx2x41rv8t26bx9i40gv8w0qbxfn3z6c8yyybxld3xwa91wvbxqo"
    "3wmo94ugbxvk3vdh97rrby023u4r9aosby463swf9dljby7x3roh9gi2byb93qgy9jecbye8"
    "3p9r9mafbygt3o2w9p6abyj13mwe9s1ybyku3lq69uxgbyma3kk99xssbynb3jela0nzbynx"
    "3i95a3j1byo43h3ya6dybynw3fyxa98sbyn73eu2ac3hbym13dpdaey4bykd3ckuahsobyi8"
    "3bgfakn5byfk3ac4anhkbycc397yaqbxby8j383wat69by4636zzaw0jbxz635w7ayutbxtl"
    "34skb1p1bxnb33p3b4j9bxgc32lrb7dhbx8n31inba7pbx0730fsbd1wbwqz2zd7bfw4bwgy"
    "2yaybiqcbw622x94blklbvub2w7uboetbvhp2v73br93bv452u70bu3cbupm2t7obwxnbua3"
    "2s99bzrybttk2rbtc2m9btbx2qfkc5glbst82pklc8axbs9d2or6cb5abroe2nzfcdzmbr27"
    "2n9jcgtzbqet2mlqcjobbpq52m07cminbp072lh8cpczbo8x2l11cs7abngb2knwcv1kbmma"
    "2ke2cxvtblqw2k7sd0q0bku22k5bd3k5bjvq2k6zd6e9bivw2kczd98abhuj2knldc29bgrm"
    "2l32dew4bfn42lnodhpwbeh12mdkdkjlbd9a2n90dnd5bbzv2oa4dq6lbaos2ph2dszvb9bz"
    "2qtzdvt1b7xf2sczdym0b6h42u24e1eub4z12vxge47gb3f52xyze6zwb1tf306qe9s3b05v"
    "32kneck3aygf354oefbuawp437usei3bauvx3aquekujat0s3dsrenlhar3q3h0geqc4ap4p"
    "3kdret2gan3q3nwkevsgal0r3rkreyi4aivt3ve5f17eagot3zcnf3wbaeft43g2f6kuac4s"
    "47obf98za9rp4c17fbwoa7ck4gimfejxa4vd4l4gfh6qa2c44pukfjt19zqq4uotfmew9x39"
    "4zn3fp079udp54pafrl09rm059vafu5a9os85f4zfwoz9lwc5ki9fz849iyb5pz1g1qn9fy5"
    "5vj9g48k9cvt616tg6pv99rc66xlg96i96kq6crjgbmh93bz6iokge1s90136oolggge8wo2"
    "6urlgiua8t8w70xggl7g8prk7765gnju8m817dhmgpvh8imd7jvsgs6b8eyk7qclgugc8b8m"
    "7wvygwpk87gi83hvgyxx83mb8a69h15g7zpy8gx2h3c37vrh8nq9h5hv7rqw8ulth7mp7no5"
    "91joh9qm7jja98jrhbtl7fcc9fm1hdvm7b3b9mqghfwo76s89twyhhwr72f3a15hhjvt6xzy"
    "a8g0hltw6tirafsihnqx6ozlan6vhpmw6kehaun3hrhu6freb254htbq6b2fb9owhv4j66bj"
    "bhadhww961isboxghymv5woabwm4i0ce5rs1c4cai20u5mu5cc3vi3o65huncjwui5ad5ctl"
    "crr3i6vh57r5czmli8fh52ncd7j9i9yd4xicdfgzibg54sc9dnfqicwu4n58dvfdiecg4hxh"
    "e3fuifqz4cp6ebh2ih4f47glejixiigu427zerlcijs83wzpezo7il2l3rs3f7reimbz3mll"
    "ffuvinke3hgrfnyhiorw3ce5fw24ipyh37ehg45oir4732ikgc91is942xrcgkc4itd82t5x"
    "gseriugl2orhh0gwivja2klhh8ieiwla2gphhgj4ixmp2d57hoj0iynk29yhhwhyiznx277a"
    "i4ftj0nu24xiiccij1nd2370ik7xj2mk221dis20j3lh21huizunj4k621laj7lsj5io22bz"
    "jfbbj6h323ppjmz6j7ff25ppjul6j8du28avk25cj9ca2bfnk9nojaav2f2ekh44jb9l2j5c"
    "koimjc8j2nmtkvv5jd7q2sh3l35oje772xmplae8jf713328"
)

_VIRIDIS_DIGITS = 4
FONT_ASCENT = 10      # rows above the baseline a line of text takes
FONT_DESCENT = 3      # rows below it
LINE_HEIGHT = FONT_ASCENT + FONT_DESCENT
PIECE = 8.0           # the longest piece of a segment, in pixels


def _parse_font():
    glyphs = {}
    for code, spec in enumerate(_FONT.split("|"), start=32):
        parts = spec.split(" ")
        adv = int(parts[0])
        if len(parts) == 1:
            glyphs[chr(code)] = (adv, 0, np.zeros((0, 0), bool))
            continue
        top, width, rows = int(parts[1]), int(parts[2]), parts[3]
        hexw = (width + 3) // 4
        bits = [int(rows[i:i + hexw], 16) for i in range(0, len(rows), hexw)]
        mask = np.array([[(b >> (width - 1 - c)) & 1 for c in range(width)] for b in bits], bool)
        glyphs[chr(code)] = (adv, top, mask)
    return glyphs


GLYPHS = _parse_font()
VIRIDIS = np.array([int(_VIRIDIS[i:i + _VIRIDIS_DIGITS], 36) / 1e6
                    for i in range(0, len(_VIRIDIS), _VIRIDIS_DIGITS)]).reshape(256, 3)
VIRIDIS_RGBA = np.concatenate([VIRIDIS, np.ones((256, 1))], axis=1)
# matplotlib's default colour cycle's first entry, "C0" (#1f77b4)
C0 = np.array([0x1F / 255, 0x77 / 255, 0xB4 / 255, 1.0])


def normalize(c: np.ndarray) -> np.ndarray:
    """matplotlib's ``Normalize`` autoscaled on ``c`` (float64): (c - min) /
    (max - min), all zeros where the values are constant."""
    c = np.asarray(c, dtype=np.float64)
    vmin, vmax = float(c.min()), float(c.max())
    if vmin == vmax:
        return np.zeros_like(c)
    return (c - vmin) / (vmax - vmin)


def viridis(x: np.ndarray) -> np.ndarray:
    """RGBA of normalized values as matplotlib's ``Colormap.__call__``
    picks them: index ⌊x·256⌋ (1.0 is the last entry), below 0 the first,
    at or above 1 the last, NaN transparent black."""
    x = np.asarray(x, dtype=np.float64) * 256
    x[x == 256] = 255
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = np.where(bad, 0, x).astype(int)
    idx = np.clip(idx, 0, 255)
    idx[x < 0] = 0
    out = VIRIDIS_RGBA[idx]
    out[bad] = 0.0
    return out


def map_colors(c: Optional[np.ndarray], n: int) -> np.ndarray:
    """[n, 4] RGBA of scatter points: ``c`` through ``normalize`` and
    ``viridis``, or C0 for every point when ``c`` is None."""
    if c is None:
        return np.tile(C0, (n, 1))
    return viridis(normalize(c))


class Canvas:
    """An 8-bit RGB image, row 0 at the top; x grows right and y down, in
    pixels, with pixel (i, j) centred at (j + 0.5, i + 0.5).  Colours are
    floats in [0, 1]; each drawing blends in floats over the pixels it
    covers and rounds them back to 8 bits."""

    def __init__(self, width: int, height: int, background=(1.0, 1.0, 1.0)):
        self.rgb = np.empty((height, width, 3), np.uint8)
        self.rgb[:] = _to_u8(background[:3])

    @property
    def size(self) -> Tuple[int, int]:
        return self.rgb.shape[1], self.rgb.shape[0]

    def _blend(self, y0, x0, alpha, color) -> None:
        """``color`` over the pixels from (x0, y0) on with coverage
        ``alpha`` [h, w] (times the colour's own alpha); only the covered
        pixels are touched."""
        h, w = alpha.shape
        region = self.rgb[y0:y0 + h, x0:x0 + w]
        ys, xs = np.nonzero(alpha)
        a = alpha[ys, xs, None] * (color[3] if len(color) > 3 else 1.0)
        mixed = region[ys, xs] * (1.0 - a) + a * (255.0 * np.asarray(color[:3], np.float64))
        region[ys, xs] = np.round(mixed)

    def _stamps(self, x0, y0, size: int):
        """Pixel windows of ``size`` x ``size`` with top lefts (x0, y0)
        [n]: their integer corners and the centres of their pixels, x
        [n, 1, size] and y [n, size, 1]."""
        xi, yi = np.floor(x0).astype(int), np.floor(y0).astype(int)
        off = np.arange(size)
        xs = (xi[:, None] + off + 0.5)[:, None, :]
        ys = (yi[:, None] + off + 0.5)[:, :, None]
        return xi, yi, xs, ys

    def _accumulate(self, xi, yi, alpha):
        """Coverage [n, size, size] at the windows' corners merged by
        maximum into one layer over their bounding box (clipped to the
        image); returns the layer's corner and the layer."""
        W, H = self.size
        size = alpha.shape[-1]
        xa, ya = max(int(xi.min()), 0), max(int(yi.min()), 0)
        xb, yb = min(int(xi.max()) + size, W), min(int(yi.max()) + size, H)
        if xa >= xb or ya >= yb:
            return None
        off = np.arange(size)
        xx = np.broadcast_to((xi[:, None] + off)[:, None, :], alpha.shape)
        yy = np.broadcast_to((yi[:, None] + off)[:, :, None], alpha.shape)
        keep = (xx >= xa) & (xx < xb) & (yy >= ya) & (yy < yb) & (alpha > 0)
        layer = np.zeros((yb - ya, xb - xa))
        np.maximum.at(layer, (yy[keep] - ya, xx[keep] - xa), alpha[keep])
        return ya, xa, layer

    def segments(self, segs: np.ndarray, width: float, color, antialias: bool = True) -> None:
        """Line segments [E, 2, 2] of (x, y) end points, ``width`` pixels
        wide, with round caps, in one colour: each cut into pieces of at
        most ``PIECE`` pixels (small windows for numpy to compute at
        once), whose coverages merge by maximum before one blend, so that
        crossing lines do not darken."""
        piece = PIECE
        segs = np.asarray(segs, dtype=np.float64).reshape(-1, 2, 2)
        if not len(segs):
            return
        r = width / 2
        p0, d = segs[:, 0], segs[:, 1] - segs[:, 0]
        n = np.maximum(np.ceil(np.hypot(d[:, 0], d[:, 1]) / piece), 1).astype(int)
        idx = np.repeat(np.arange(len(segs)), n)
        k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        a = p0[idx] + d[idx] * (k / n[idx])[:, None]
        dd = d[idx] / n[idx][:, None]
        size = int(np.ceil(piece + 2 * r + 3))
        lo = np.minimum(a, a + dd) - r - 1
        xi, yi, xs, ys = self._stamps(lo[:, 0], lo[:, 1], size)
        ax, ay = a[:, 0, None, None], a[:, 1, None, None]
        dx, dy = dd[:, 0, None, None], dd[:, 1, None, None]
        L2 = dx * dx + dy * dy
        t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / np.where(L2 > 0, L2, 1.0), 0, 1)
        dist = np.hypot(xs - (ax + t * dx), ys - (ay + t * dy))
        alpha = np.clip(r + 0.5 - dist, 0, 1) if antialias else (dist <= r).astype(np.float64)
        merged = self._accumulate(xi, yi, alpha)
        if merged is not None:
            self._blend(*merged, color)

    def discs(self, centers: np.ndarray, radius: float, colors: np.ndarray,
              antialias: bool = True) -> None:
        """Filled discs at ``centers`` [n, 2], one RGBA each, drawn in
        order."""
        centers = np.asarray(centers, dtype=np.float64).reshape(-1, 2)
        if not len(centers):
            return
        size = int(np.ceil(2 * radius + 3))
        xi, yi, xs, ys = self._stamps(centers[:, 0] - radius - 1, centers[:, 1] - radius - 1,
                                      size)
        dist = np.hypot(xs - centers[:, 0, None, None], ys - centers[:, 1, None, None])
        alpha = (np.clip(radius + 0.5 - dist, 0, 1) if antialias
                 else (dist <= radius).astype(np.float64))
        W, H = self.size
        for x0, y0, al, color in zip(xi, yi, alpha, colors):
            xa, ya = max(x0, 0), max(y0, 0)
            xb, yb = min(x0 + size, W), min(y0 + size, H)
            if xa < xb and ya < yb:
                self._blend(ya, xa, al[ya - y0:yb - y0, xa - x0:xb - x0], color)

    def rect(self, x0: float, y0: float, x1: float, y1: float, color) -> None:
        """A filled rectangle over the pixels whose centres lie inside."""
        W, H = self.size
        xa, xb = max(int(round(x0)), 0), min(int(round(x1)), W)
        ya, yb = max(int(round(y0)), 0), min(int(round(y1)), H)
        if xa < xb and ya < yb:
            self.rgb[ya:yb, xa:xb] = _to_u8(color[:3])

    def frame(self, x0: float, y0: float, x1: float, y1: float, color=(0, 0, 0)) -> None:
        """A one-pixel rectangle outline."""
        self.rect(x0, y0, x1, y0 + 1, color)
        self.rect(x0, y1 - 1, x1, y1, color)
        self.rect(x0, y0, x0 + 1, y1, color)
        self.rect(x1 - 1, y0, x1, y1, color)

    def image(self, x0: int, y0: int, rgb: np.ndarray) -> None:
        """Paste an [h, w, 3] image of colours in [0, 1] with its top left at
        (x0, y0), clipped."""
        W, H = self.size
        h, w = rgb.shape[:2]
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + w, W), min(y0 + h, H)
        if xa < xb and ya < yb:
            self.rgb[ya:yb, xa:xb] = _to_u8(rgb[ya - y0:yb - y0, xa - x0:xb - x0])

    def text(self, x: float, y: float, s: str, color=(0, 0, 0), ha: str = "center",
             va: str = "center", rotate: bool = False) -> None:
        """``s`` in the bitmap font, anchored at (x, y) by ``ha`` (left,
        center, right) and ``va`` (top, center, bottom); ``rotate`` turns
        it a quarter counter-clockwise."""
        mask = text_mask(s)
        if rotate:
            mask = np.rot90(mask)
        h, w = mask.shape
        x0 = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        y0 = {"top": y, "center": y - h / 2, "bottom": y - h}[va]
        xi, yi = int(round(x0)), int(round(y0))
        W, H = self.size
        xa, ya = max(xi, 0), max(yi, 0)
        xb, yb = min(xi + w, W), min(yi + h, H)
        if xa < xb and ya < yb:
            self._blend(ya, xa, mask[ya - yi:yb - yi, xa - xi:xb - xi].astype(np.float64), color)



def _to_u8(color) -> np.ndarray:
    return np.round(np.clip(np.asarray(color, np.float64), 0, 1) * 255).astype(np.uint8)


def text_mask(s: str) -> np.ndarray:
    """[LINE_HEIGHT, width] bool mask of ``s`` on one line; an em dash is
    drawn as "-", any other character outside printable ASCII as "?"."""
    s = s.replace("—", "-").replace("–", "-")
    glyphs = [GLYPHS.get(ch, GLYPHS["?"]) for ch in s]
    out = np.zeros((LINE_HEIGHT, max(sum(g[0] for g in glyphs), 1)), bool)
    x = 0
    for adv, top, mask in glyphs:
        if mask.size:
            r0 = FONT_ASCENT - top
            rows = slice(max(r0, 0), min(r0 + mask.shape[0], LINE_HEIGHT))
            sub = mask[rows.start - r0:rows.stop - r0, :out.shape[1] - x]
            out[rows, x:x + sub.shape[1]] |= sub
        x += adv
    return out


def text_width(s: str) -> int:
    return text_mask(s).shape[1]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``pixels`` [H, W, 3] uint8: one IHDR, one IDAT
    (every row unfiltered), IEND."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, _ = pixels.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(pixels))
