"""Make the ImageNet tar fixture of the port's loader tests.

Writes ``imagenet_tars/n0000000{0,1,2}.tar``: three synsets of four
32×32 JPEGs each (PIL, quality 95), a well-separated base colour a
synset under low-frequency noise, as ``tests/test_stream_e2e.py`` makes
its tars; the second tar carries a fifth member in its middle that is
not a JPEG.  Then ``imagenet_tars_decoded.npy``: the (13, 32, 32, 3)
uint8 pixels that the reference's native libjpeg decode
(``native/keystone_native.cpp`` § ks_decode_jpegs) gives for every
member in index order, zeros for the member that does not decode (the
stream's rule).

Needs PIL, JAX on the CPU and the reference's native library
(``make -C native``).  Run from the repository's root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/make_imagenet_tars.py
"""

import io
import os
import tarfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "imagenet_tars")
PIXELS = os.path.join(HERE, "imagenet_tars_decoded.npy")
SIZE = (32, 32)
ANCHORS = np.array([[200, 60, 60], [60, 200, 60], [60, 60, 200]], np.float32)


def _jpeg(rng, base_color) -> bytes:
    from PIL import Image

    base = base_color + rng.uniform(-15, 15, size=(3,))
    img = np.tile(base, (*SIZE, 1)) + rng.normal(0, 8, (*SIZE, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _write_tar(path, members) -> None:
    """A ustar archive without tarfile's padding to 10 KiB records: the
    end-of-archive blocks close it, and readers need nothing more."""
    with tarfile.open(path, "w", format=tarfile.USTAR_FORMAT) as tf:
        for name, data in members:
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        end = tf.offset + 2 * tarfile.BLOCKSIZE
    with open(path, "r+b") as f:
        f.truncate(end)


def main() -> None:
    rng = np.random.default_rng(0)
    os.makedirs(ROOT, exist_ok=True)
    for t in range(3):
        syn = f"n{t:08d}"
        members = [(f"{syn}_{j}.JPEG", _jpeg(rng, ANCHORS[t])) for j in range(4)]
        if t == 1:
            members.insert(2, (f"{syn}_bad.JPEG", b"this member is not a JPEG"))
        _write_tar(os.path.join(ROOT, f"{syn}.tar"), members)

    from keystone_tpu import native
    from keystone_tpu.loaders.imagenet import ImageNetLoader, _decode_entry_batch

    if not native.available():
        raise SystemExit("the reference's native library is not built: make -C native")
    entries = ImageNetLoader.index(ROOT)
    np.save(PIXELS, _decode_entry_batch(entries, SIZE))
    print(f"{len(entries)} members; {sum(os.path.getsize(os.path.join(ROOT, f)) for f in os.listdir(ROOT))} "
          f"bytes of tars; {os.path.getsize(PIXELS)} bytes of pixels")


if __name__ == "__main__":
    main()
