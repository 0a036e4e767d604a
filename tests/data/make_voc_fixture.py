"""Make the VOC fixture of the port's loader tests and chip check.

Writes ``voc/JPEGImages/*.jpg`` and ``voc/Annotations/*.xml`` in VOC
2007's layout: 30 JPEGs (PIL, quality 90) of four classes (aeroplane,
bicycle, bird, person), each an oriented grating in a colour of its
class under noise, in a few sizes around 64×48; a third of them name a
second object of another class in their XML.  Besides them, an
annotation without its JPEG (``index`` skips it) and a ``.jpg`` that is
not a JPEG (it decodes to a zero image).  Then ``voc_decoded.npy``: the
(31, 48, 48, 3) uint8 pixels the reference's native libjpeg decode
(``native/keystone_native.cpp`` § ks_decode_jpegs) gives for the
indexed files in index order at 48×48, zeros for the one that does not
decode.

Needs PIL, JAX on the CPU and the reference's native library
(``make -C native``).  Run from the repository's root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/make_voc_fixture.py
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "voc")
IMAGES = os.path.join(ROOT, "JPEGImages")
ANNOTATIONS = os.path.join(ROOT, "Annotations")
PIXELS = os.path.join(HERE, "voc_decoded.npy")
SIZE = (48, 48)
CLASSES = ["aeroplane", "bicycle", "bird", "person"]
COLORS = np.array([[220, 70, 60], [60, 200, 80], [70, 80, 220], [200, 190, 60]], np.float32)
SHAPES = [(48, 64), (56, 72), (40, 60)]


def _image(rng, c: int, shape) -> np.ndarray:
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    angle = np.pi * c / len(CLASSES)
    grating = 0.5 + 0.5 * np.sin(0.6 * (np.cos(angle) * xx + np.sin(angle) * yy) + rng.uniform(0, 2 * np.pi))
    img = grating[..., None] * COLORS[c] + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _xml(stem: str, names) -> str:
    objs = "".join(f"<object><name>{n}</name><difficult>0</difficult></object>" for n in names)
    return f"<annotation><filename>{stem}.jpg</filename>{objs}</annotation>\n"


def main() -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(IMAGES, exist_ok=True)
    os.makedirs(ANNOTATIONS, exist_ok=True)
    for i in range(30):
        stem = f"{i:06d}"
        c = i % len(CLASSES)
        names = [CLASSES[c]]
        if i % 3 == 0:
            names.append(CLASSES[(c + 1 + i // 3) % len(CLASSES)])
        Image.fromarray(_image(rng, c, SHAPES[i % len(SHAPES)])).save(os.path.join(IMAGES, stem + ".jpg"),
                                                                      format="JPEG", quality=90)
        with open(os.path.join(ANNOTATIONS, stem + ".xml"), "w") as f:
            f.write(_xml(stem, names))
    with open(os.path.join(ANNOTATIONS, "000030.xml"), "w") as f:  # no JPEG: not indexed
        f.write(_xml("000030", ["bird"]))
    with open(os.path.join(IMAGES, "000031.jpg"), "wb") as f:  # indexed, does not decode
        f.write(b"this file is not a JPEG")
    with open(os.path.join(ANNOTATIONS, "000031.xml"), "w") as f:
        f.write(_xml("000031", ["person"]))

    from keystone_tpu import native
    from keystone_tpu.loaders.voc import VOCLoader

    if not native.available():
        raise SystemExit("the reference's native library is not built: make -C native")
    loaded = VOCLoader.load(IMAGES, ANNOTATIONS, size=SIZE)
    np.save(PIXELS, np.asarray(loaded.data.array)[:loaded.data.n])
    size = sum(os.path.getsize(os.path.join(d, f)) for d in (IMAGES, ANNOTATIONS) for f in os.listdir(d))
    print(f"{loaded.data.n} indexed images; {size} bytes of files; {os.path.getsize(PIXELS)} bytes of pixels")


if __name__ == "__main__":
    main()
