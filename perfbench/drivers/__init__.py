"""One module a kind of traffic (a traffic file's `driver`): set-up, the
measured window, the traced segment and the comparison with the
reference."""
