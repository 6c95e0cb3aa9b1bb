"""The service layer on the port's engine: so far the slot-map restore
that AppContext runs when it reopens the indexes (`app.py`)."""
