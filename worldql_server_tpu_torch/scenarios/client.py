"""Minimal real-wire ZeroMQ peer for the scenario engine.

Speaks the actual wire protocol over actual sockets — the same path an
external game plugin takes — so scenarios exercise transports, codec,
admission and delivery, not in-process shortcuts. Deliberately tiny:
connect/resume handshake (session tokens + retry-after refusals
included), send, recv-until, hard drop.
"""

from __future__ import annotations

import asyncio
import socket
import uuid as uuid_mod

import zmq
import zmq.asyncio

from ..protocol import (
    Instruction,
    Message,
    deserialize_message,
    serialize_message,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def free_port_block(n: int, attempts: int = 64) -> int:
    """A base port with ``base..base+n`` all currently free — cluster
    configs derive shard listener ports as ``base + 1 + shard_id``."""
    for _ in range(attempts):
        socks = []
        try:
            first = socket.socket()
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            socks.append(first)
            for off in range(1, n + 1):
                s = socket.socket()
                s.bind(("127.0.0.1", base + off))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("could not find a free port block")


class ZmqPeer:
    """One scenario client. ``token`` carries the session token from
    the handshake echo; ``retry_after_ms`` is set instead when the
    handshake was refused by the admission governor."""

    def __init__(self, ctx, push, pull, uuid: uuid_mod.UUID):
        self.ctx = ctx
        self.push = push
        self.pull = pull
        self.uuid = uuid
        self.token: str | None = None
        self.retry_after_ms: int | None = None
        self.address: str | None = None

    @classmethod
    async def connect(
        cls,
        server_port: int,
        host: str = "127.0.0.1",
        peer_uuid: uuid_mod.UUID | None = None,
        token: str | None = None,
        timeout: float = 5.0,
    ) -> "ZmqPeer":
        peer = cls.open(server_port, host, peer_uuid)
        return await peer.handshake(token, timeout)

    @classmethod
    def open(
        cls,
        server_port: int,
        host: str = "127.0.0.1",
        peer_uuid: uuid_mod.UUID | None = None,
    ) -> "ZmqPeer":
        """The client's sockets, bound and connected, before any
        handshake: ``connect`` is ``open`` then ``handshake``. A storm
        opens its clients first, so that its timed window holds the
        handshakes and not each client's context and port bind."""
        ctx = zmq.asyncio.Context()
        pull = ctx.socket(zmq.PULL)
        client_port = pull.bind_to_random_port(f"tcp://{host}")
        push = ctx.socket(zmq.PUSH)
        push.setsockopt(zmq.LINGER, 0)
        push.connect(f"tcp://{host}:{server_port}")
        peer = cls(ctx, push, pull, peer_uuid or uuid_mod.uuid4())
        peer.address = f"{host}:{client_port}"
        return peer

    async def handshake(self, token: str | None = None,
                        timeout: float = 5.0) -> "ZmqPeer":
        try:
            await self.send(Message(
                instruction=Instruction.HANDSHAKE,
                parameter=self.address,
                flex=token.encode() if token is not None else None,
            ))
            echo = await self.recv(timeout)
            assert echo.instruction == Instruction.HANDSHAKE
            if echo.parameter is not None:
                if echo.parameter.startswith("retry-after:"):
                    self.retry_after_ms = int(echo.parameter.split(":", 1)[1])
                else:
                    self.token = echo.parameter
        except BaseException:
            self.close()
            raise
        return self

    @property
    def refused(self) -> bool:
        return self.retry_after_ms is not None

    async def send(self, message: Message) -> None:
        message.sender_uuid = self.uuid
        await self.push.send(serialize_message(message))

    async def recv(self, timeout: float = 5.0) -> Message:
        data = await asyncio.wait_for(self.pull.recv(), timeout)
        return deserialize_message(data)

    async def recv_until(
        self, instruction: Instruction, timeout: float = 5.0
    ) -> Message:
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            left = deadline - asyncio.get_running_loop().time()
            if left <= 0:
                raise asyncio.TimeoutError()
            message = await self.recv(left)
            if message.instruction == instruction:
                return message

    def close(self) -> None:
        """Hard drop: sockets die with no goodbye — the network-blip
        shape the session plane exists for."""
        self.push.close(linger=0)
        self.pull.close(linger=0)
        self.ctx.term()
