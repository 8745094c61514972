"""LightClientServer — produce light-client updates from imported blocks.

Reference: packages/beacon-node/src/chain/lightClient/index.ts
(LightClientServer: onImportBlock -> persist best update per period,
latest finality/optimistic updates, bootstrap by block root).  An
imported block's sync_aggregate attests its parent; the parent's
post-state supplies the finality and next-sync-committee merkle
branches (produced here with ssz.container_branch — the
persistent-merkle-tree getSingleProof analog).

The port's copy of `lodestar_tpu/chain/light_client_server.py`; it
imports nothing of the JAX package.  It differs from the JAX server in
one repair (ROADMAP Queue C item 3): the JAX server proves an attested
state under altair's container whatever its fork, and hashes every
parent body as an altair body, so from bellatrix on its committee
branch and its attested header's `body_root` are wrong.  Here the
branches come from the attested state's own fork container
(`state._container()`), on the planes and on the host path alike, and a
header's `body_root` from its block's own body type
(`config.get_fork_types`).  On altair states the two servers give the
same bytes.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, Optional

from .. import params
from ..light_client.lightclient import LightClientUpdate, sync_period
from ..proofs.plane_reader import state_multiproof, state_proof
from ..ssz.core import container_branches
from ..types import BeaconBlockHeader
from ..utils.logger import get_logger
from .emitter import ChainEvent

P = params.ACTIVE_PRESET


def _block_header_value(config, block: dict) -> dict:
    """The block's header, its body hashed under the block's own fork."""
    body_type = config.get_fork_types(int(block["slot"]))[2]
    return {
        "slot": block["slot"],
        "proposer_index": block["proposer_index"],
        "parent_root": block["parent_root"],
        "state_root": block["state_root"],
        "body_root": body_type.hash_tree_root(block["body"]),
    }


class LightClientServer:
    # In-memory retention window in sync periods (~27h each on
    # mainnet): the db keeps EVERY period's best update; serving an
    # older one falls back there, so a node running for months holds a
    # bounded map instead of one entry per period forever
    # (cache-hygiene — the block_state_roots bug class).
    MAX_MEMORY_PERIODS = 32

    def __init__(self, chain):
        self.chain = chain
        self.log = get_logger("chain/lightclient")
        self.best_update_by_period: Dict[int, LightClientUpdate] = {}
        self.latest_finality_update: Optional[LightClientUpdate] = None
        self.latest_optimistic_update: Optional[LightClientUpdate] = None
        self.produced = 0
        # proof-source accounting: branches read off warm engine planes
        # (O(log n), zero re-hash) vs the container_branch host pass
        self.plane_proofs = 0
        self.host_proofs = 0
        # per-period best updates survive restarts (reference:
        # db/repositories/lightclientBestUpdate.ts)
        self.db = getattr(chain, "db", None)
        if self.db is not None and hasattr(
            self.db, "light_client_best_update"
        ):
            self._restore()
        chain.emitter.on(ChainEvent.block, self.on_imported_block)

    def _restore(self) -> None:
        from ..network.reqresp_protocols import (
            LightClientUpdateType,
            light_client_update_from_value,
        )

        n = 0
        for key, raw in self.db.light_client_best_update.entries():
            period = int.from_bytes(key, "big")
            value = LightClientUpdateType.deserialize(raw)
            self.best_update_by_period[period] = (
                light_client_update_from_value(value)
            )
            n += 1
        self._prune_memory()  # only the newest window stays resident
        if n:
            self.log.info("light-client best updates restored", periods=n)

    def _persist(self, period: int, update: LightClientUpdate) -> None:
        if self.db is None or not hasattr(
            self.db, "light_client_best_update"
        ):
            return
        from ..network.reqresp_protocols import (
            LightClientUpdateType,
            light_client_update_to_value,
        )

        self.db.light_client_best_update.put(
            int(period).to_bytes(8, "big"),
            LightClientUpdateType.serialize(
                light_client_update_to_value(update)
            ),
        )

    # -- production (reference: lightClient/index.ts onImportBlock) --------

    def on_imported_block(self, signed_block: dict, root: bytes) -> None:
        block = signed_block["message"]
        agg = block["body"].get("sync_aggregate")
        if agg is None or not any(agg["sync_committee_bits"]):
            return
        parent_hex = block["parent_root"].hex()
        try:
            attested_state = self.chain.regen._get_post_state(parent_hex)
        except Exception as e:  # parent state unavailable: skip quietly
            self.log.warn("no attested state for light client", error=str(e))
            return
        if self.chain.db is not None:
            parent_signed = self.chain.db.get_block_anywhere(
                block["parent_root"]
            )
        else:
            parent_signed = None
        if parent_signed is not None:
            attested_header = _block_header_value(
                self.chain.config, parent_signed["message"]
            )
        else:
            # anchor parent: its header lives in the state
            attested_header = dict(attested_state.latest_block_header)
            if attested_header["state_root"] == b"\x00" * 32:
                attested_header["state_root"] = (
                    attested_state.hash_tree_root()
                )

        # plane-first: both branches straight off the warm engine planes
        # (zero re-hash), under a residency lease so the read cannot
        # race the governor demoting the attested state mid-extraction;
        # the planes and the host path both prove under the attested
        # state's own fork container
        lc_paths = [["next_sync_committee"], ["finalized_checkpoint", "root"]]
        with self._lease(parent_hex):
            proofs = state_multiproof(attested_state, lc_paths)
        if proofs is not None:
            self.plane_proofs += 1
        else:
            # host fall-through: one field-root pass serves both proofs
            # (the validator-registry merkleization dominates; see
            # ssz.container_branches)
            proofs = self._host_branches(attested_state, lc_paths)
        (
            (_leaf, nsc_branch, _nd, _ni),
            (_froot, fin_branch, _fd, _fi),
        ) = proofs

        finalized_header = None
        finality_branch = None
        fin_root = attested_state.finalized_checkpoint["root"]
        if any(fin_root) and self.chain.db is not None:
            # archived finalized blocks remain reachable via the root
            # index (the Archiver migrates them out of the hot repo)
            fin_signed = self.chain.db.get_block_anywhere(fin_root)
            if fin_signed is not None:
                finalized_header = _block_header_value(
                    self.chain.config, fin_signed["message"]
                )
                finality_branch = fin_branch

        update = LightClientUpdate(
            attested_header=attested_header,
            sync_committee_bits=list(agg["sync_committee_bits"]),
            sync_committee_signature=agg["sync_committee_signature"],
            signature_slot=block["slot"],
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            next_sync_committee=dict(
                attested_state.next_sync_committee
            ),
            next_sync_committee_branch=nsc_branch,
        )
        self.produced += 1

        period = sync_period(attested_header["slot"])
        best = self.best_update_by_period.get(period)
        # spec is_better_update (simplified): finality wins over raw
        # participation; participation breaks ties
        new_rank = (
            update.finalized_header is not None,
            sum(update.sync_committee_bits),
        )
        if best is None or new_rank > (
            best.finalized_header is not None,
            sum(best.sync_committee_bits),
        ):
            self.best_update_by_period[period] = update
            self._persist(period, update)
            self._prune_memory()
        self.latest_optimistic_update = update
        if finalized_header is not None:
            self.latest_finality_update = update
        self.chain.emitter.emit(ChainEvent.light_client_update, update)

    # -- serving (reference: lightClient/index.ts getUpdate/getBootstrap) --

    def _prune_memory(self) -> None:
        while len(self.best_update_by_period) > self.MAX_MEMORY_PERIODS:
            del self.best_update_by_period[min(self.best_update_by_period)]

    def get_update(self, period: int) -> Optional[LightClientUpdate]:
        upd = self.best_update_by_period.get(period)
        if upd is not None:
            return upd
        # older than the memory window: the db kept it
        if self.db is None or not hasattr(
            self.db, "light_client_best_update"
        ):
            return None
        raw = self.db.light_client_best_update.get(
            int(period).to_bytes(8, "big")
        )
        if raw is None:
            return None
        from ..network.reqresp_protocols import (
            LightClientUpdateType,
            light_client_update_from_value,
        )

        return light_client_update_from_value(
            LightClientUpdateType.deserialize(raw)
        )

    def get_finality_update(self) -> Optional[LightClientUpdate]:
        return self.latest_finality_update

    def get_optimistic_update(self) -> Optional[LightClientUpdate]:
        return self.latest_optimistic_update

    def get_bootstrap(self, block_root: bytes) -> Optional[dict]:
        """{header, current_sync_committee, branch} for a trusted root."""
        if self.chain.db is None:
            return None
        signed = self.chain.db.get_block_anywhere(block_root)
        if signed is None:
            return None
        header = _block_header_value(self.chain.config, signed["message"])
        state = self.chain.regen._get_post_state(block_root.hex())
        with self._lease(block_root.hex()):
            proof = state_proof(state, ["current_sync_committee"])
        if proof is not None:
            self.plane_proofs += 1
            _leaf, branch, _depth, _index = proof
        else:
            ((_leaf, branch, _depth, _index),) = self._host_branches(
                state, [["current_sync_committee"]]
            )
        return {
            "header": header,
            "current_sync_committee": dict(state.current_sync_committee),
            "current_sync_committee_branch": branch,
        }

    def _host_branches(self, state, paths):
        """The host pass for branches the planes could not serve: it
        re-merkleizes every field of `state`, so it is counted and
        logged with the registry size and its time, never taken in
        silence."""
        t = time.perf_counter()
        proofs = container_branches(
            state._container(), state.to_value(), paths
        )
        self.host_proofs += 1
        self.log.warn(
            "light-client branches re-merkleized on the host",
            validators=state.num_validators,
            ms=round((time.perf_counter() - t) * 1e3, 3),
        )
        return proofs

    def _lease(self, root_hex: str):
        """Residency lease on the state-cache entry backing a plane
        read (no-op when the chain has no governor)."""
        gov = getattr(self.chain, "memory_governor", None)
        if gov is None or not hasattr(gov, "lease"):
            return nullcontext()
        return gov.lease(("state", root_hex))
