"""A request of one query or more, one ``engine.search(query, db)`` each."""


def make(engine, db, qobjs: list):
    return lambda idx: [engine.search(qobjs[i], db) for i in idx]
