"""Host-side pixel preprocessing (counterpart of
`actor_critic_tpu/envs/pixel_wrappers.py`): the Atari wrapper stack of
grayscale → 84×84 resize → k-frame stack → reward clip, for any host
pixel env behind `HostEnvPool(..., pixel_preprocess=True)`.

Plain numpy (and cv2 where it imports), so the same frames give the JAX
wrapper's bytes: the same ITU-R 601 luma, cv2's `INTER_AREA` resize, or the
same nearest-neighbour grid sample when cv2 is missing.

gymnasium and cv2 are imported at first use, not at import: the card's
machine has neither, and the port's modules are imported there.
`PixelPreprocess` (a `gymnasium.Wrapper`) is built on first access of the
name.
"""

from __future__ import annotations

from collections import deque

import numpy as np

_CV2 = None  # the cv2 module, False where it does not import; None until asked


def _cv2():
    global _CV2
    if _CV2 is None:
        try:
            import cv2

            _CV2 = cv2
        except Exception:
            _CV2 = False
    return _CV2


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return frame
    # ITU-R 601 luma, the coefficients cv2 uses.
    return (
        frame[..., 0] * 0.299 + frame[..., 1] * 0.587 + frame[..., 2] * 0.114
    ).astype(np.uint8)


def _resize(frame: np.ndarray, size: int) -> np.ndarray:
    if frame.shape[:2] == (size, size):
        return frame
    cv2 = _cv2()
    if cv2:
        return cv2.resize(frame, (size, size), interpolation=cv2.INTER_AREA)
    # Nearest-neighbour fallback (no cv2): index-sample the grid.
    h, w = frame.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return frame[np.ix_(ys, xs)]


def _make_class():
    import gymnasium as gym

    class PixelPreprocess(gym.Wrapper):
        """grayscale → size×size resize → `stack` frames on the channel axis
        (uint8 [size, size, stack]) → optional sign reward clip and action
        repeat: the observation contract of `envs/pong.py`, so the same CNN
        torso takes either."""

        def __init__(self, env, size: int = 84, stack: int = 4, action_repeat: int = 1,
                     clip_reward: bool = True):
            super().__init__(env)
            self.size = size
            self.stack = stack
            self.action_repeat = max(action_repeat, 1)
            self.clip_reward = clip_reward
            self._frames: deque[np.ndarray] = deque(maxlen=stack)
            self.observation_space = gym.spaces.Box(0, 255, (size, size, stack), np.uint8)

        def _obs(self) -> np.ndarray:
            return np.stack(self._frames, axis=-1)

        def _push(self, frame: np.ndarray) -> None:
            self._frames.append(_resize(_to_gray(np.asarray(frame)), self.size))

        def reset(self, **kwargs):
            obs, info = self.env.reset(**kwargs)
            self._frames.clear()
            self._push(obs)
            while len(self._frames) < self.stack:
                self._frames.append(self._frames[-1])
            return self._obs(), info

        def step(self, action):
            total = 0.0
            terminated = truncated = False
            info: dict = {}
            for _ in range(self.action_repeat):
                obs, reward, terminated, truncated, info = self.env.step(action)
                total += float(reward)
                if terminated or truncated:
                    break
            self._push(obs)
            if self.clip_reward:
                total = float(np.sign(total))
            return self._obs(), total, terminated, truncated, info

    return PixelPreprocess


def __getattr__(name: str):
    if name == "PixelPreprocess":
        cls = _make_class()
        globals()[name] = cls
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
