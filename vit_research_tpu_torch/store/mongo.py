"""MongoDB connectivity stub.

Port of vit_research_tpu/store/mongo.py: the reference keeps an unused
Mongo stub (one insert against localhost), kept for API parity and gated
on pymongo being installed; the vector store (store/vector_store.py) is
the real persistence layer. Without pymongo, :func:`get_client` returns
None and :func:`insert_one` returns False.
"""

from __future__ import annotations

_clients: dict = {}


def get_client(uri: str = "mongodb://localhost:27017/"):
    """One cached MongoClient per uri (each client owns a connection pool
    and monitor threads, so a client a call would leak both), or None
    without pymongo."""
    try:
        from pymongo import MongoClient
    except ImportError:
        return None
    if uri not in _clients:
        _clients[uri] = MongoClient(uri)
    return _clients[uri]


def insert_one(collection_name: str, doc: dict, *, db_name: str = "nba",
               uri: str = "mongodb://localhost:27017/") -> bool:
    """Insert ``doc``; False (with a note) when pymongo is unavailable."""
    client = get_client(uri)
    if client is None:
        print("[mongo] pymongo unavailable; skipping insert")
        return False
    client[db_name][collection_name].insert_one(doc)
    return True
