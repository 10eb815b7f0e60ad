"""A request of many queries in one ``engine.search_many(queries, db)``."""


def make(engine, db, qobjs: list):
    return lambda idx: engine.search_many([qobjs[i] for i in idx], db)
