"""Serving: the request/response contract (``api``), the
``submit``/``stream``/``run`` facade over either backend (``session``)
and the asyncio HTTP front end (``server``), copied from the reference."""
