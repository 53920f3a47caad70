"""transport_ms.push (ms): the client's median ``stream_push`` time, from
send to the audio received, less the daemon's own median: the socket,
the JSON and base64 coding on both sides, and the client."""


def read(obs):
    if obs.get("kind") != "serve" or not obs.get("daemon_push_ms"):
        return None
    return obs["client_push_ms"] - obs["daemon_push_ms"]
