"""One file a kernel: ``PATTERN``, the regular expression its device
operations' names match, and ``bound_s(work)``, the least time the work that
the traffic asked of it in the traced window can take. ``work`` is the
driver's count of that work (``rows``, ``hidden``, ``dim``, ``n_blocks`` and
the number of forwards, heads or steps); each input byte is counted read once
and each output byte written once."""
