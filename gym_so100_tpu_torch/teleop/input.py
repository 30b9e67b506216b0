"""Teleoperation input layer: controller abstraction + gamepad/keyboard.

The port's copy of `gym_so100_tpu/teleop/input.py` (host Python, unchanged
in behaviour): input devices are host peripherals, so this layer stays
plain Python.  `InputController` is the contract (deltas, episode status
flags, context manager); `GamepadControllerHID` decodes hidapi reports by
byte offset per product layout and is unavailable when the `hid` module or
a device is missing; `KeyboardController` reads the terminal and takes
injected keys (the browser viewer's keydowns)."""

from __future__ import annotations

import time


class InputController:
    """Base class: accumulates deltas and episode status."""

    def __init__(self, x_step_size=1.0, y_step_size=1.0, z_step_size=1.0):
        self.x_step_size = x_step_size
        self.y_step_size = y_step_size
        self.z_step_size = z_step_size
        self.running = True
        self.episode_end_status = None
        self.intervention_flag = False
        self.open_gripper_command = False
        self.close_gripper_command = False

    def start(self):
        pass

    def stop(self):
        pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def get_deltas(self):
        return 0.0, 0.0, 0.0

    def update(self):
        pass

    def should_save(self):
        return self.episode_end_status is not None

    def should_quit(self):
        return not self.running

    def gripper_command(self):
        if self.open_gripper_command == self.close_gripper_command:
            return "no-op"
        return "open" if self.open_gripper_command else "close"


class GamepadLayout:
    """HID input-report byte layout for one controller family.

    The reference hardcodes a single Logitech RumblePad 2 layout inline
    (gamepad_utils.py:165-232: dpad nibble at byte 1, four stick axes at
    bytes 2-5, a shoulder/trigger bitfield at byte 6, an analog LT at
    byte 7, face buttons at byte 8); other matched product strings get the
    same offsets and simply mis-decode.  Here the layout is data, so each
    family declares its own offsets and the decode loop is shared.

    Attributes are byte indices into the report (None = not present):
    `dpad` a (index, value->direction) table; `axes` the four stick bytes
    in (left_x, left_y, right_x, right_y) order; `trig_bits` the bitfield
    byte tested for RB/RT/LT; `buttons` the face-button bitfield byte with
    `save/fail/rerecord` bit positions.
    """

    def __init__(self, axes, buttons, save_bit, fail_bit, rerecord_bit,
                 dpad=None, dpad_map=None, trig_bits=None, lt=None, rt=None,
                 shoulder=None, intervene_bit=1, min_len=8):
        self.axes = axes
        self.buttons = buttons
        self.save_bit = save_bit
        self.fail_bit = fail_bit
        self.rerecord_bit = rerecord_bit
        self.dpad = dpad
        self.dpad_map = dpad_map or {}
        self.trig_bits = trig_bits
        self.lt = lt
        self.rt = rt
        # Sony pads carry L1/R1/L2/R2 in a separate bitfield byte; when
        # `trig_bits` is absent, intervention comes from `shoulder` bit
        # `intervene_bit` (R1) and gripper open/close from the lt/rt analogs
        self.shoulder = shoulder
        self.intervene_bit = intervene_bit
        self.min_len = min_len


# hat-switch nibble -> direction, shared by the layouts below
_HAT8 = {0: "up", 2: "right", 4: "down", 6: "left"}

LAYOUTS = {
    # Logitech RumblePad 2 / F310 in DirectInput mode: the reference's one
    # decoded device (gamepad_utils.py:174-232).
    "Logitech": GamepadLayout(
        axes=(3, 2, 4, 5), buttons=8,
        save_bit=7, fail_bit=5, rerecord_bit=4,
        dpad=1, dpad_map={15: None, **_HAT8},
        trig_bits=6, lt=7, min_len=9,
    ),
    # Sony DualSense over USB (report 0x01): sticks at 1-4, L2/R2 analog at
    # 5/6, seq counter at 7, hat nibble + face buttons share byte 8
    # (square/cross/circle/triangle bits 4-7), L1/R1/... bitfield at byte 9.
    "DualSense": GamepadLayout(
        axes=(1, 2, 3, 4), buttons=8,
        save_bit=7, fail_bit=4, rerecord_bit=5,
        dpad=8, dpad_map=_HAT8,
        lt=5, rt=6, shoulder=9, min_len=10,
    ),
    # Sony DualShock 4 over USB (product string "Wireless Controller",
    # report 0x01): sticks at 1-4, hat nibble + face buttons share byte 5,
    # L1/R1/L2/R2 bitfield at byte 6, triggers analog at 8/9.
    "Wireless Controller": GamepadLayout(
        axes=(1, 2, 3, 4), buttons=5,
        save_bit=7, fail_bit=4, rerecord_bit=5,
        dpad=5, dpad_map=_HAT8,
        lt=8, rt=9, shoulder=6, min_len=10,
    ),
    # Xbox-compatible / 8BitDo in XInput-over-HID form: sticks 16-bit LE
    # would need struct decode; the common HID fallback report mirrors the
    # Logitech shape with buttons one byte later.
    "Xbox": GamepadLayout(
        axes=(3, 2, 4, 5), buttons=8,
        save_bit=7, fail_bit=5, rerecord_bit=4,
        dpad=1, dpad_map={15: None, **_HAT8},
        trig_bits=6, lt=7, min_len=9,
    ),
    "8BitDo": GamepadLayout(
        axes=(3, 2, 4, 5), buttons=8,
        save_bit=7, fail_bit=5, rerecord_bit=4,
        dpad=1, dpad_map={15: None, **_HAT8},
        trig_bits=6, lt=7, min_len=9,
    ),
}

KNOWN_PRODUCTS = tuple(LAYOUTS)


class GamepadControllerHID(InputController):
    """hidapi-based gamepad reader (reference gamepad_utils.py:69-232).

    Full decode per report: dpad direction, four stick axes with deadzone,
    analog triggers (`lt`/`rt` in [0,1]), RB-held intervention flag,
    RT/LT gripper open/close, and face-button episode tagging — matching
    the reference's Logitech decode and extending it to per-product
    layouts via the LAYOUTS table."""

    def __init__(self, *args, deadzone=0.1, **kw):
        super().__init__(*args, **kw)
        self.deadzone = deadzone
        self.device = None
        self.layout = None
        self.left_x = self.left_y = self.right_x = self.right_y = 0.0
        self.direction = None
        self.lt = 0.0
        self.rt = 0.0

    def start(self):
        try:
            import hid
        except ImportError as e:
            raise RuntimeError(
                "gamepad support needs the 'hid' package (hidapi)"
            ) from e
        for info in hid.enumerate():
            prod = (info.get("product_string") or "")
            for key in KNOWN_PRODUCTS:
                if key in prod:
                    self.layout = LAYOUTS[key]
                    self.device = hid.device()
                    self.device.open_path(info["path"])
                    self.device.set_nonblocking(True)
                    return
        raise RuntimeError("no known gamepad found")

    def stop(self):
        if self.device is not None:
            self.device.close()
            self.device = None

    @staticmethod
    def _axis(v, deadzone):
        x = (v - 128) / 128.0
        return 0.0 if abs(x) < deadzone else x

    def update(self):
        if self.device is None:
            return
        # drain up to 10 reports per update; HID nonblocking reads return
        # stale frames until the queue empties (gamepad_utils.py:157-163)
        for _ in range(10):
            data = self.device.read(64)
            if not data:
                break
            self._decode(data)

    def _decode(self, data):
        lay = self.layout
        if lay is None or len(data) < lay.min_len:
            return
        ax = lay.axes
        self.left_x = self._axis(data[ax[0]], self.deadzone)
        self.left_y = self._axis(data[ax[1]], self.deadzone)
        self.right_x = self._axis(data[ax[2]], self.deadzone)
        self.right_y = self._axis(data[ax[3]], self.deadzone)
        if lay.dpad is not None:
            self.direction = lay.dpad_map.get(data[lay.dpad] & 0x0F)
        if lay.lt is not None and len(data) > lay.lt:
            self.lt = data[lay.lt] / 255.0
        if lay.rt is not None and len(data) > lay.rt:
            self.rt = data[lay.rt] / 255.0
        if lay.trig_bits is not None and len(data) > lay.trig_bits:
            tb = data[lay.trig_bits]
            # RB bit 1 held = human intervention; RT bit 3 opens, LT bit 2
            # closes (the reference's enumerated value sets
            # gamepad_utils.py:216-222 are exactly these bit tests)
            self.intervention_flag = bool(tb & 0x02)
            self.open_gripper_command = bool(tb & 0x08)
            self.close_gripper_command = bool(tb & 0x04)
        else:
            # Sony pads: triggers are analog-only — threshold them for the
            # gripper, and read intervention (R1) from the shoulder bitfield
            self.open_gripper_command = self.rt > 0.5
            self.close_gripper_command = self.lt > 0.5
            if lay.shoulder is not None and len(data) > lay.shoulder:
                self.intervention_flag = bool(
                    data[lay.shoulder] & (1 << lay.intervene_bit)
                )
        buttons = data[lay.buttons] if len(data) > lay.buttons else 0
        if buttons & (1 << lay.save_bit):
            self.episode_end_status = "success"
        elif buttons & (1 << lay.fail_bit):
            self.episode_end_status = "failure"
        elif buttons & (1 << lay.rerecord_bit):
            self.episode_end_status = "rerecord_episode"
        else:
            self.episode_end_status = None

    def get_deltas(self):
        # stick-to-world mapping as in the reference (gamepad_utils.py:
        # 239-249): left stick xy moves the EE in the plane, right stick y
        # drives z; signs flipped for a "push forward = away" feel
        return (
            -self.left_x * self.x_step_size,
            -self.left_y * self.y_step_size,
            -self.right_y * self.z_step_size,
        )


class KeyboardController(InputController):
    """stdin-based fallback (the reference falls back to keyboard when no
    gamepad is present, record_teleop.py:199-206).  Non-blocking reads via
    termios/select; works in any terminal, no display needed."""

    KEYMAP = {
        "a": (0, +1), "z": (0, -1),
        "s": (1, +1), "x": (1, -1),
        "d": (2, +1), "c": (2, -1),
        "f": (3, +1), "v": (3, -1),
        "g": (4, +1), "b": (4, -1),
        "h": (5, +1), "n": (5, -1),
    }

    def __init__(self, *args, step=0.05, **kw):
        super().__init__(*args, **kw)
        self.step = step
        self.joint_deltas = [0.0] * 6
        self._old = None
        self._injected = []
        self._inj_lock = __import__("threading").Lock()

    def inject(self, ch):
        """Queue a key from another source (e.g. the browser viewer's
        /key endpoint) to be processed on the next update(); thread-safe."""
        with self._inj_lock:
            self._injected.append(ch)

    def start(self):
        import sys

        try:
            import termios, tty

            self._old = termios.tcgetattr(sys.stdin)
            tty.setcbreak(sys.stdin.fileno())
            self._tty = True
        except Exception:
            # no tty (piped stdin / headless service): browser-injected keys
            # via inject() remain the input channel (record_teleop --watch)
            self._tty = False

    def stop(self):
        if self._old is not None:
            import sys, termios

            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, self._old)
            self._old = None

    def _handle(self, ch):
        if ch == "q":
            self.running = False
        elif ch == "1":
            self.episode_end_status = "success"
        elif ch == "2":
            self.episode_end_status = "failure"
        elif ch == "3":
            self.episode_end_status = "rerecord_episode"
        elif ch in self.KEYMAP:
            j, s = self.KEYMAP[ch]
            self.joint_deltas[j] += s * self.step

    def update(self):
        import select
        import sys

        self.joint_deltas = [0.0] * 6
        with self._inj_lock:
            injected, self._injected = self._injected, []
        for ch in injected:
            self._handle(ch)
        if not getattr(self, "_tty", True):
            return
        while select.select([sys.stdin], [], [], 0)[0]:
            self._handle(sys.stdin.read(1))
