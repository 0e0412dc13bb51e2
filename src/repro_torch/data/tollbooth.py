"""Synthetic Toll Booth stream (Linear-Road-inspired, Rodosol-ALPR stand-in).

A fixed camera watches a toll lane.  Cars (colored rectangles with a brand
stripe pattern and a rendered license plate) enter from the left, drive
through the lower half of the frame, and exit right.  Every frame carries
full ground-truth labels, which is what lets us measure the paper's
query-level accuracy offline (the real paper uses an annotated dataset).

Frame layout (channels-first uint8, default 128×256):
  rows   0- 63 : background (sky/booth) — irrelevant to all queries
  rows  64-127 : road; cars occupy rows ~72-120
The car body carries `n_stripes(brand)` vertical dark stripes; the plate is
a white 14×66 box at the car's rear with 6 glyphs from a 3×5 bitmap font.

Stream metadata mirrors the paper's reasoning inputs: fps, v_max, lane
geometry — the semantic optimizer's "world knowledge" measurements have
ground truth to be checked against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

COLORS = ["red", "blue", "green", "white", "black", "yellow"]
COLOR_RGB = {
    "red": (200, 30, 30),
    "blue": (30, 60, 200),
    "green": (30, 170, 60),
    "white": (230, 230, 230),
    "black": (25, 25, 25),
    "yellow": (220, 210, 40),
}
BRANDS = ["astra", "bolt", "cresta", "dyno", "evora", "falcon"]
PLATE_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"

# 3x5 bitmap font (per char: 5 rows of 3 bits)
_FONT = {
    "A": "010101111101101", "B": "110101110101110", "C": "011100100100011",
    "D": "110101101101110", "E": "111100110100111", "F": "111100110100100",
    "G": "011100101101011", "H": "101101111101101", "I": "111010010010111",
    "J": "001001001101010", "K": "101110100110101", "L": "100100100100111",
    "M": "101111111101101", "N": "101111111111101", "O": "010101101101010",
    "P": "110101110100100", "Q": "010101101011001", "R": "110101110110101",
    "S": "011100010001110", "T": "111010010010010", "U": "101101101101111",
    "V": "101101101101010", "W": "101101111111101", "X": "101010010010101",
    "Y": "101101010010010", "Z": "111001010100111",
    "0": "010101101101010", "1": "010110010010111", "2": "110001010100111",
    "3": "110001010001110", "4": "101101111001001", "5": "111100110001110",
    "6": "011100110101010", "7": "111001010010010", "8": "010101010101010",
    "9": "010101011001110",
}

CAR_H, CAR_W = 44, 88
CAR_Y = 72                     # top row of every car (fixed lane)
PLATE_H, PLATE_W = 19, 84
GLYPH_SCALE = 3                # glyph stroke width in px
# cars brake at the booth; plates are "readable" only in this x-band
# (real ALPR trigger-line semantics — also what makes a fixed-position
# readout learnable by the small stream MLLM)
READ_ZONE = (78.0, 98.0)
ZONE_SLOWDOWN = 0.35


@dataclasses.dataclass
class Car:
    x: float                   # left edge (can be negative / beyond W)
    speed: float               # px / frame
    color: str
    brand: str
    plate: str


class TollBoothStream:
    """Deterministic, seekable frame stream with labels."""

    def __init__(self, height: int = 128, width: int = 256, fps: int = 30,
                 car_rate: float = 0.009, seed: int = 0,
                 v_max_kmh: float = 30.0, stolen_plate_prefix: str = "MTT",
                 stolen_rate: float = 0.15, repeat_rate: float = 0.25):
        self.h, self.w, self.fps = height, width, fps
        self.seed = seed
        self.car_rate = car_rate
        self.v_max_kmh = v_max_kmh
        self.stolen_prefix = stolen_plate_prefix
        self.stolen_rate = stolen_rate
        self.repeat_rate = repeat_rate
        self._past_cars: List[Tuple[str, str, str]] = []
        self.metadata = {
            "fps": fps, "v_max_kmh": v_max_kmh,
            "scene": "fixed camera, toll lane, cars left-to-right",
        }
        self._cars: List[Car] = []
        self._rs = np.random.RandomState(seed)
        self._index = 0

    # ------------------------------------------------------------------
    def reset(self, seed: Optional[int] = None) -> None:
        self._cars = []
        self._past_cars = []
        self._rs = np.random.RandomState(self.seed if seed is None else seed)
        self._index = 0

    def _new_car(self) -> Car:
        rs = self._rs
        # a known car returns (enables Q7 repeated-car detection)
        if self._past_cars and rs.rand() < self.repeat_rate:
            color, brand, plate = self._past_cars[
                rs.randint(len(self._past_cars))]
            speed = 4.0 + 3.0 * rs.rand()
            return Car(x=-CAR_W - 1.0, speed=speed, color=color, brand=brand,
                       plate=plate)
        color = COLORS[rs.randint(len(COLORS))]
        brand = BRANDS[rs.randint(len(BRANDS))]
        if rs.rand() < self.stolen_rate:
            prefix = self.stolen_prefix
            color = "red"
        else:
            prefix = "".join(PLATE_CHARS[rs.randint(26)] for _ in range(3))
            # avoid accidental stolen prefix
            if prefix == self.stolen_prefix:
                prefix = "AAA"
        digits = "".join(str(rs.randint(10)) for _ in range(3))
        plate = prefix + digits
        speed = 4.0 + 3.0 * rs.rand()          # px/frame
        self._past_cars.append((color, brand, plate))
        return Car(x=-CAR_W - 1.0, speed=speed, color=color, brand=brand,
                   plate=plate)

    # ------------------------------------------------------------------
    def _render_car(self, frame: np.ndarray, car: Car) -> None:
        x0 = int(round(car.x))
        x1 = x0 + CAR_W
        vx0, vx1 = max(0, x0), min(self.w, x1)
        if vx1 <= vx0:
            return
        y0, y1 = CAR_Y, CAR_Y + CAR_H
        rgb = COLOR_RGB[car.color]
        for c in range(3):
            frame[c, y0:y1, vx0:vx1] = rgb[c]
        # brand stripes: n+1 dark vertical stripes on the roof
        n_stripes = BRANDS.index(car.brand) + 1
        stripe_w = 4
        gap = (CAR_W - 16) // max(n_stripes, 1)
        for s in range(n_stripes):
            sx0 = x0 + 8 + s * gap
            sx1 = sx0 + stripe_w
            svx0, svx1 = max(0, sx0), min(self.w, sx1)
            if svx1 > svx0:
                frame[:, y0 + 4:y0 + 12, svx0:svx1] = 10
        # plate: white box with black glyphs at the rear (left) of the car
        px0 = x0 + 2
        py0 = y0 + CAR_H - PLATE_H - 2
        pvx0, pvx1 = max(0, px0), min(self.w, px0 + PLATE_W)
        if pvx1 > pvx0:
            frame[:, py0:py0 + PLATE_H, pvx0:pvx1] = 245
        # glyphs: 3x5 font at GLYPH_SCALE => 9x15 per char, 14px pitch
        g = GLYPH_SCALE
        for ci, ch in enumerate(car.plate):
            bits = _FONT[ch]
            gx0 = px0 + 2 + ci * (3 * g + 5)
            gy0 = py0 + 2
            for r in range(5):
                for cc in range(3):
                    if bits[r * 3 + cc] == "1":
                        yy0, yy1 = gy0 + r * g, gy0 + (r + 1) * g
                        xx0, xx1 = gx0 + cc * g, gx0 + (cc + 1) * g
                        xx0c, xx1c = max(0, xx0), min(self.w, xx1)
                        if xx1c > xx0c:
                            frame[:, yy0:yy1, xx0c:xx1c] = 5

    def _background(self) -> np.ndarray:
        frame = np.zeros((3, self.h, self.w), np.uint8)
        frame[:, : self.h // 2] = 150                     # sky
        frame[0, : self.h // 2] = 140
        frame[2, : self.h // 2] = 170
        frame[:, self.h // 2:] = 90                       # road
        # lane markings
        frame[:, self.h - 8: self.h - 6, :] = 180
        # per-frame sensor noise
        noise = self._rs.randint(0, 6, frame.shape).astype(np.uint8)
        return frame + noise

    # ------------------------------------------------------------------
    def next_frame(self) -> Tuple[np.ndarray, Dict]:
        rs = self._rs
        # spawn
        if rs.rand() < self.car_rate and (
                not self._cars or self._cars[-1].x > 60):
            self._cars.append(self._new_car())
        # move (cars brake inside the booth read zone)
        for car in self._cars:
            in_zone = READ_ZONE[0] - 10 <= car.x <= READ_ZONE[1] + 4
            car.x += car.speed * (ZONE_SLOWDOWN if in_zone else 1.0)
        self._cars = [c for c in self._cars if c.x < self.w + 2]

        frame = self._background()
        visible = []
        for car in self._cars:
            if car.x + CAR_W > 0 and car.x < self.w:
                self._render_car(frame, car)
                visible.append(car)
        readable = [c for c in visible
                    if READ_ZONE[0] <= c.x <= READ_ZONE[1]]
        main = readable[0] if readable else None
        label = {
            "index": self._index,
            "car_present": bool(visible),
            "car_readable": main is not None,
            "color": main.color if main else None,
            "brand": main.brand if main else None,
            "plate": main.plate if main else None,
            "stolen": bool(main and main.color == "red"
                           and main.plate.startswith(self.stolen_prefix)),
            "n_cars": len(visible),
        }
        self._index += 1
        return frame, label

    def batch(self, n: int) -> Tuple[np.ndarray, List[Dict]]:
        frames, labels = [], []
        for _ in range(n):
            f, l = self.next_frame()
            frames.append(f)
            labels.append(l)
        return np.stack(frames), labels

    def booth_batch(self, n: int) -> Tuple[np.ndarray, List[Dict]]:
        """Dense training batch: every frame has one car inside the read
        zone (the supervised 'booth shot' distribution — used only for
        operator-model training, never for query evaluation)."""
        rs = self._rs
        frames, labels = [], []
        for _ in range(n):
            car = self._new_car()
            car.x = READ_ZONE[0] + rs.rand() * (READ_ZONE[1] - READ_ZONE[0])
            frame = self._background()
            self._render_car(frame, car)
            frames.append(frame)
            labels.append({
                "index": -1, "car_present": True, "car_readable": True,
                "color": car.color, "brand": car.brand, "plate": car.plate,
                "stolen": car.color == "red"
                and car.plate.startswith(self.stolen_prefix),
                "n_cars": 1,
            })
        return np.stack(frames), labels
