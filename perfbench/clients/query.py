"""A request is one ``db.query`` call: the query set's segments in the
caller's order, the configuration's ``d``, and the mix's ``query_kwargs``
(the backend ``"kernel"`` unless the mix names another)."""


def make(db, d: float, mix: dict):
    kwargs = {"backend": "kernel", **mix.get("query_kwargs", {})}

    def request(queries):
        return db.query(queries, d, **kwargs)

    return request
