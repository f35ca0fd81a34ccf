"""Event-list -> XML output, matching the reference's predict format.

The reference assembles ``<AudioDoc><SoundCaptionList><SoundSegment ...>``
strings by hand (``pytorch/predict.py:266-406``); semantics preserved:
events sorted by onset, a fallback "Others" segment when nothing is
detected, and ``dur = offset - onset``.

A copy of ``sed_tpu/post/xml_writer.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional
from xml.sax.saxutils import escape


def _attr(value) -> str:
    """Escape text bound for an XML attribute (the reference concatenates
    raw strings, which yields invalid XML for names/ASR transcripts
    containing ``& < > "``; class labels never contain those, so escaped
    output is byte-identical for all reference-reachable inputs)."""
    return escape(str(value), {'"': '&quot;'})


def events_to_xml(events: List[dict], doc_name: str,
                  fallback_span: Optional[tuple] = None) -> str:
    """Render an event list as an AudioDoc XML string.

    Args:
      events: [{'onset', 'offset', 'event_label', (optional) 'text'}, ...]
      doc_name: the audio file's base name.
      fallback_span: (stime, etime) for the "Others" segment emitted when
        no events were detected (``pytorch/predict.py:397-399``).
    """
    parts = ['<AudioDoc name="{}">\n'.format(_attr(doc_name)),
             '\t<SoundCaptionList>\n']
    if events:
        for event in sorted(events, key=lambda e: e['onset']):
            label = event['event_label']
            if 'text' in event:
                parts.append(
                    '\t\t<SoundSegment stime="{}" dur="{}" event="{}" '
                    'text="{}">{}</SoundSegment>\n'.format(
                        event['onset'], event['offset'] - event['onset'],
                        _attr(label), _attr(event['text']),
                        escape(str(label))))
            else:
                parts.append(
                    '\t\t<SoundSegment stime="{}" dur="{}" event="{}">{}'
                    '</SoundSegment>\n'.format(
                        event['onset'], event['offset'] - event['onset'],
                        _attr(label), escape(str(label))))
    else:
        stime, etime = fallback_span if fallback_span else (0, 0)
        parts.append(
            '\t\t<SoundSegment stime="{}" dur="{}">Others</SoundSegment>\n'
            .format(stime, etime - stime))
    parts.append('\t</SoundCaptionList>\n')
    parts.append('</AudioDoc>')
    return ''.join(parts)
