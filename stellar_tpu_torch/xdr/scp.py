"""Wire types from the reference's src/xdr/Stellar-SCP.x (87 lines)."""

from __future__ import annotations

import enum
from typing import List, Optional

from .base import (
    DepthLimited,
    option,
    uint32,
    uint64,
    var_array,
    var_opaque,
    xenum,
    xf,
    xstruct,
    xunion,
)
from .xtypes import HASH, PUBLIC_KEY, SIGNATURE, PublicKey

VALUE = var_opaque()  # typedef opaque Value<>


@xstruct
class SCPBallot:
    counter: int = xf(uint32, 0)  # n
    value: bytes = xf(VALUE, b"")  # x


class SCPStatementType(enum.IntEnum):
    SCP_ST_PREPARE = 0
    SCP_ST_CONFIRM = 1
    SCP_ST_EXTERNALIZE = 2
    SCP_ST_NOMINATE = 3


@xstruct
class SCPNomination:
    quorumSetHash: bytes = xf(HASH, b"\x00" * 32)  # D
    votes: List[bytes] = xf(var_array(VALUE), factory=list)  # X
    accepted: List[bytes] = xf(var_array(VALUE), factory=list)  # Y


@xstruct
class SCPStatementPrepare:
    quorumSetHash: bytes = xf(HASH, b"\x00" * 32)  # D
    ballot: SCPBallot = xf(SCPBallot._codec, factory=SCPBallot)  # b
    prepared: Optional[SCPBallot] = xf(option(SCPBallot._codec), None)  # p
    preparedPrime: Optional[SCPBallot] = xf(option(SCPBallot._codec), None)  # p'
    nC: int = xf(uint32, 0)
    nP: int = xf(uint32, 0)


@xstruct
class SCPStatementConfirm:
    quorumSetHash: bytes = xf(HASH, b"\x00" * 32)  # D
    nPrepared: int = xf(uint32, 0)  # n_p
    commit: SCPBallot = xf(SCPBallot._codec, factory=SCPBallot)  # c
    nP: int = xf(uint32, 0)


@xstruct
class SCPStatementExternalize:
    commit: SCPBallot = xf(SCPBallot._codec, factory=SCPBallot)  # c
    nP: int = xf(uint32, 0)
    commitQuorumSetHash: bytes = xf(HASH, b"\x00" * 32)  # D before EXTERNALIZE


@xunion(
    xenum(SCPStatementType),
    {
        SCPStatementType.SCP_ST_PREPARE: ("prepare", SCPStatementPrepare._codec),
        SCPStatementType.SCP_ST_CONFIRM: ("confirm", SCPStatementConfirm._codec),
        SCPStatementType.SCP_ST_EXTERNALIZE: (
            "externalize",
            SCPStatementExternalize._codec,
        ),
        SCPStatementType.SCP_ST_NOMINATE: ("nominate", SCPNomination._codec),
    },
)
class SCPStatementPledges:
    type: SCPStatementType
    value: object = None


@xstruct
class SCPStatement:
    nodeID: PublicKey = xf(PUBLIC_KEY)  # v
    slotIndex: int = xf(uint64, 0)  # i
    pledges: SCPStatementPledges = xf(SCPStatementPledges._codec)


@xstruct
class SCPEnvelope:
    statement: SCPStatement = xf(SCPStatement._codec)
    signature: bytes = xf(SIGNATURE, b"")


_QSET_RECURSION = DepthLimited(max_depth=8)

@xstruct
class SCPQuorumSet:
    threshold: int = xf(uint32, 0)
    validators: List[PublicKey] = xf(var_array(PUBLIC_KEY), factory=list)
    innerSets: List["SCPQuorumSet"] = xf(var_array(_QSET_RECURSION), factory=list)


# Tie the recursive knot in place, so the codec in the struct codec AND the
# codec in the dataclass field metadata are the same object.  The reference
# allows only 2 levels of nesting (Stellar-SCP.x:80 comment), enforced
# semantically in the herder; the depth-8 bound here is pure decode safety.
_QSET_RECURSION.inner = SCPQuorumSet._codec
