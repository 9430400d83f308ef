"""Clean twin of bad_unmapped_http.py: the ValueError maps to a 400."""


class Handler:
    def do_POST(self):
        try:
            n_p = self._parse_n_p()
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        self._send(200, {"n_p": n_p})

    def _parse_n_p(self):
        raw = str(getattr(self, "body", ""))
        if not raw.isdigit():
            raise ValueError(f"n_p must be an integer, got {raw!r}")
        return int(raw)

    def _send(self, code, payload):
        self.last = (code, payload)
