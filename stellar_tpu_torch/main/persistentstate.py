"""PersistentState: storestate KV table (reference: src/main/PersistentState.*).

Known entries (PersistentState.h:18-25): lastclosedledger, historyarchivestate,
forcescponnextlaunch, databaseinitialized, databaseschema, lastscpdata.
"""

from __future__ import annotations

from typing import Optional

K_LAST_CLOSED_LEDGER = "lastclosedledger"
K_HISTORY_ARCHIVE_STATE = "historyarchivestate"
K_FORCE_SCP_ON_NEXT_LAUNCH = "forcescponnextlaunch"
K_DATABASE_INITIALIZED = "databaseinitialized"
K_DATABASE_SCHEMA = "databaseschema"
K_LAST_SCP_DATA = "lastscpdata"


class PersistentState:
    def __init__(self, db):
        self._db = db

    @staticmethod
    def drop_all(db) -> None:
        db.execute("DROP TABLE IF EXISTS storestate")
        db.execute(
            """CREATE TABLE storestate (
                statename  CHARACTER(32) PRIMARY KEY,
                state      TEXT
            )"""
        )

    def get_state(self, name: str) -> Optional[str]:
        row = self._db.query_one(
            "SELECT state FROM storestate WHERE statename=?", (name,)
        )
        return row[0] if row else None

    def set_state(self, name: str, value: str) -> None:
        self._db.execute(
            "INSERT INTO storestate (statename, state) VALUES (?,?) "
            "ON CONFLICT(statename) DO UPDATE SET state=excluded.state",
            (name, value),
        )

    def clear_state(self, name: str) -> None:
        self._db.execute("DELETE FROM storestate WHERE statename=?", (name,))
