"""Synthetic Volleyball stream (Ibrahim et al. group-activity stand-in).

A *moving* camera (global jitter + slow pan) watches a court with two teams
of colored players and a ball.  Per-frame ground truth: the group action
(idle / pass / set / spike), per-player jumping flags, and which team is
attacking — enough to evaluate Q10–Q13.

Dynamics: the ball follows scripted rallies; a player under a descending
high ball "jumps" (y offset); a fast downward ball over the net line is a
spike.  Moving background texture makes frame-differencing much less
informative than in Toll Booth — which is exactly why the paper's semantic
gains are smaller on this stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

ACTIONS = ["idle", "pass", "set", "spike"]
TEAM_RGB = {0: (220, 60, 60), 1: (60, 90, 220)}
N_PER_TEAM = 6


class VolleyballStream:
    def __init__(self, height: int = 128, width: int = 256, fps: int = 25,
                 seed: int = 0):
        self.h, self.w, self.fps = height, width, fps
        self.seed = seed
        self.metadata = {
            "fps": fps,
            "scene": "moving camera, volleyball court, two teams",
        }
        self.reset()

    def reset(self) -> None:
        rs = np.random.RandomState(self.seed)
        self._rs = rs
        self._index = 0
        self._cam = 0.0
        # players: (team, base_x, base_y)
        self._players = []
        for team in (0, 1):
            for i in range(N_PER_TEAM):
                bx = 24 + i * 32 + (8 if team else -8)
                by = 70 + 22 * team + rs.randint(-4, 5)
                self._players.append([team, float(bx), float(by)])
        self._ball = [self.w / 2, 40.0, 2.0, 0.0]  # x, y, vx, vy
        self._phase = "idle"
        self._phase_t = 0

    # ------------------------------------------------------------------
    def _step_dynamics(self) -> Tuple[str, List[bool], int]:
        rs = self._rs
        bx, by, vx, vy = self._ball
        self._phase_t += 1
        action = "idle"
        jumping = [False] * len(self._players)
        attack_team = 0

        if self._phase == "idle" and rs.rand() < 0.08:
            self._phase = "pass"
            self._phase_t = 0
            vy = -3.0
            vx = 2.0 * (1 if rs.rand() < 0.5 else -1)
        elif self._phase == "pass" and self._phase_t > 8:
            self._phase = "set"
            self._phase_t = 0
            vy = -4.0
        elif self._phase == "set" and self._phase_t > 10:
            self._phase = "spike"
            self._phase_t = 0
            vy = 6.0
            vx = 3.0 * (1 if vx > 0 else -1)
        elif self._phase == "spike" and self._phase_t > 6:
            self._phase = "idle"
            self._phase_t = 0
            vy = 0.0
            vx = 1.0

        action = self._phase
        # gravity-ish
        if self._phase in ("pass", "set"):
            vy += 0.3
        bx += vx
        by += vy
        if bx < 10 or bx > self.w - 10:
            vx = -vx
        by = float(np.clip(by, 16, 100))
        self._ball = [bx, by, vx, vy]

        attack_team = 0 if vx > 0 else 1
        # players near a high ball jump during set/spike
        for idx, (team, px, py) in enumerate(self._players):
            if self._phase in ("set", "spike") and abs(px - bx) < 24 \
                    and team == attack_team:
                jumping[idx] = True
        return action, jumping, attack_team

    def _render(self, jumping: List[bool]) -> np.ndarray:
        rs = self._rs
        self._cam += rs.randn() * 1.5 + 0.2          # pan + jitter
        cam = int(round(self._cam)) % 32
        frame = np.zeros((3, self.h, self.w), np.uint8)
        # moving textured background (stands)
        xs = (np.arange(self.w) + cam)
        tex = (40 + 30 * ((xs // 16) % 2)).astype(np.uint8)
        frame[:, : self.h // 3, :] = tex[None, None, :]
        frame[:, self.h // 3:, :] = 120                      # court
        net_x = self.w // 2 + (cam % 5) - 2
        frame[:, 40:100, net_x:net_x + 2] = 220              # net
        for idx, (team, px, py) in enumerate(self._players):
            x = int(px) + cam // 2
            y = int(py) - (8 if jumping[idx] else 0)
            rgb = TEAM_RGB[team]
            x0, x1 = max(0, x - 4), min(self.w, x + 4)
            y0, y1 = max(0, y - 8), min(self.h, y + 8)
            for c in range(3):
                frame[c, y0:y1, x0:x1] = rgb[c]
        bx, by = int(self._ball[0]), int(self._ball[1])
        frame[:, max(0, by - 3):by + 3, max(0, bx - 3):bx + 3] = 250
        noise = rs.randint(0, 8, frame.shape).astype(np.uint8)
        return frame + noise

    # ------------------------------------------------------------------
    def next_frame(self) -> Tuple[np.ndarray, Dict]:
        action, jumping, attack_team = self._step_dynamics()
        frame = self._render(jumping)
        label = {
            "index": self._index,
            "action": action,
            "n_jumping": int(sum(jumping)),
            "attack_team": attack_team,
            "car_present": True,  # uniform key so shared code paths work
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
