"""Violating fixture: a handler whose body parser raises ValueError with
no arm mapping it to a status code."""


class Handler:
    def do_POST(self):
        n_p = self._parse_n_p()
        self._send(200, {"n_p": n_p})

    def _parse_n_p(self):
        raw = str(getattr(self, "body", ""))
        if not raw.isdigit():
            raise ValueError(f"n_p must be an integer, got {raw!r}")
        return int(raw)

    def _send(self, code, payload):
        self.last = (code, payload)
