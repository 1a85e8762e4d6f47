"""Write the JPEG fixtures beside this file: small JPEGs made by
``cv2.imwrite`` at odd sizes, every sampling factor it writes, progressive,
optimised Huffman tables, restart intervals, gray, and an EXIF Orientation
tag, each with what ``cv2.imread`` gives for it as ``<name>.rgb.npy``
(``IMREAD_COLOR``, then BGR -> RGB) and ``<name>.gray.npy``
(``IMREAD_GRAYSCALE``).  Hosts without ``cv2`` hold the port's decoder
against these arrays.

    python tests/data/jpeg/make_fixtures.py
"""
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
# name: (height, width, quality, sampling, progressive, optimise, restart
# interval, gray, EXIF orientation)
FIXTURES = {
    "s444_q95": (48, 64, 95, "444", 0, 0, 0, False, 0),
    "s422_q75_odd": (37, 53, 75, "422", 0, 0, 0, False, 0),
    "s420_q50_odd": (45, 61, 50, "420", 0, 0, 0, False, 0),
    "s440_q75_odd": (33, 47, 75, "440", 0, 0, 0, False, 0),
    "s411_q75_odd": (29, 63, 75, "411", 0, 0, 0, False, 0),
    "s420_prog": (48, 64, 75, "420", 1, 0, 0, False, 0),
    "s444_prog_odd": (41, 39, 90, "444", 1, 0, 0, False, 0),
    "s420_opt_rst": (40, 56, 75, "420", 0, 1, 2, False, 0),
    "s422_prog_rst": (35, 51, 80, "422", 1, 1, 3, False, 0),
    "gray_q75_odd": (31, 45, 75, "444", 0, 0, 0, True, 0),
    "gray_prog": (48, 40, 85, "444", 1, 0, 0, True, 0),
    "exif_rot6": (40, 64, 75, "420", 0, 0, 0, False, 6),
}


def image(h, w, seed):
    """A smooth gradient with noise: chroma that varies, edges that ring."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / (w - 1), y * 255.0 / (h - 1),
                     (x * 7 + y * 3) % 256.0], axis=-1)
    return np.clip(base + rng.normal(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)


def with_orientation(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 Exif segment (little-endian TIFF, IFD0 holding
    only Orientation) right after SOI."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:]


def main():
    for seed, (name, spec) in enumerate(FIXTURES.items()):
        h, w, quality, sampling, prog, opt, rst, gray, orientation = spec
        img = image(h, w, seed)
        if gray:
            img = img[..., 1]
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_PROGRESSIVE, prog, cv2.IMWRITE_JPEG_OPTIMIZE, opt,
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        data = buf.tobytes()
        if orientation:
            data = with_orientation(data, orientation)
        path = os.path.join(HERE, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        rgb = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.save(os.path.join(HERE, f"{name}.rgb.npy"), rgb)
        np.save(os.path.join(HERE, f"{name}.gray.npy"),
                cv2.imread(path, cv2.IMREAD_GRAYSCALE))


if __name__ == "__main__":
    main()
