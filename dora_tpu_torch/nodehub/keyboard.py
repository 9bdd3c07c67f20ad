"""Keyboard character source (dora_tpu/nodehub/keyboard.py): one ``char``
output (the character's UTF-8 bytes) per key press.

The terminal is the keyboard: stdin in cbreak mode, read a character at a
time, so the node works over SSH and in containers. Without a TTY it sends
``KEYBOARD_SYNTHETIC`` (default "hello") as presses, ``CHAR_DELAY_MS``
apart (default 10). ``MAX_CHARS`` stops after N characters (0: no limit).
``NODE_ID`` (and ``DORA_DAEMON_ADDR``) run it as a dynamic node.
"""

from __future__ import annotations

import os
import sys
import time

from dora_tpu_torch.node import Node


def _read_tty_chars(node: Node, max_chars: int) -> None:
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sent = 0
    try:
        tty.setcbreak(fd)
        while True:
            ch = sys.stdin.read(1)
            if not ch or ch == "\x04":  # EOF / ctrl-d
                break
            node.send_output("char", ch.encode())
            sent += 1
            if max_chars and sent >= max_chars:
                break
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def _replay_synthetic(node: Node, max_chars: int) -> None:
    text = os.environ.get("KEYBOARD_SYNTHETIC", "hello")
    delay = int(os.environ.get("CHAR_DELAY_MS", "10")) / 1000.0
    for i, ch in enumerate(text):
        if max_chars and i >= max_chars:
            break
        node.send_output("char", ch.encode())
        time.sleep(delay)


def main() -> None:
    max_chars = int(os.environ.get("MAX_CHARS", "0"))
    node_id = os.environ.get("NODE_ID")
    node = Node(node_id=node_id, daemon_addr=os.environ.get("DORA_DAEMON_ADDR")) \
        if node_id else Node()
    try:
        if sys.stdin.isatty():
            _read_tty_chars(node, max_chars)
        else:
            _replay_synthetic(node, max_chars)
    finally:
        node.close()


if __name__ == "__main__":
    main()
