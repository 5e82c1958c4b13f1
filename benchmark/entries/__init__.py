"""One driver a kind of entry (today ``align``), named by
the traffic file's ``entry``."""
